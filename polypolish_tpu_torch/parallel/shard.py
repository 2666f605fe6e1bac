"""Vote and consensus over a (data, pos) device grid (counterpart of
polypolish_tpu/parallel/shard.py, whose steps are ``shard_map`` with a
``psum``).

- The host routes vote events to grid cells: round-robin over the data
  axis, by position range over the pos axis.  Events are
  position-local, so routing is a stable sort and no halo is needed.
- Each cell counts its events into a local (8, p_shard) int32 tile on
  its own device: by scatter-add (``sharded_step``, the JAX package's
  XLA scatter) or by kernel A over its lane blocks
  (``sharded_step_lanes``; ``ops.vote_lanes.lanes_counts``, the plain
  version on a CPU cell).
- The counts of a pos column sum over the data axis, exact int32 adds,
  on the device of the column's data-0 cell (the ``psum`` over "data";
  integer adds commute, so any split is bitwise the single-device
  result).
- The consensus runs on each position shard; the shards concatenate.

Thresholds stay host-computed f64 (ops/consensus.py) and go to each
position shard.  The JAX package memoises its jitted steps
(``_STEP_CACHE``); there is nothing to compile here, so nothing is
cached.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from polypolish_tpu_torch.ops import vote_lanes
from polypolish_tpu_torch.ops.consensus import consensus_dense_core
from polypolish_tpu_torch.ops.vote import scatter_add_drop
from polypolish_tpu_torch.ops.vote_lanes import lanes_counts
from polypolish_tpu_torch.utils.profiling import StageTimer
from polypolish_tpu_torch.vocab import DENSE_V

_I32MAX = 2**31 - 1


def bucket_events_for_mesh(
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    n_data: int,
    n_pos: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Route dense-tier events to (data, pos) shards.

    Returns (ev_pos (n_data, n_pos, E) int32 with local positions and
    pad = p_shard, ev_vocab likewise, p_shard).  Events are split
    round-robin over the data axis and by position range over the pos
    axis; padding events use local position == p_shard which the
    scatter drops.
    """
    mask = (vocab >= 0) & (vocab < DENSE_V) & (pos >= 0) & (pos < num_positions)
    pos = np.asarray(pos[mask], dtype=np.int64)
    vocab = np.asarray(vocab[mask], dtype=np.int32)

    p_shard = -(-num_positions // n_pos)
    p_shard = max(8, p_shard)
    shard_of = pos // p_shard
    data_of = np.arange(pos.size, dtype=np.int64) % n_data

    # per (data, pos-shard) bucket sizes -> common padded length E
    bucket = data_of * n_pos + shard_of
    counts = np.bincount(bucket, minlength=n_data * n_pos)
    e_max = max(8, int(counts.max()) if counts.size else 8)

    ev_pos = np.full((n_data, n_pos, e_max), p_shard, dtype=np.int32)
    ev_vocab = np.zeros((n_data, n_pos, e_max), dtype=np.int32)
    order = np.argsort(bucket, kind="stable")
    sorted_bucket = bucket[order]
    start = np.concatenate(([0], np.cumsum(counts)))[:-1]
    within = np.arange(pos.size) - start[sorted_bucket]
    flat_idx = sorted_bucket * e_max + within
    ev_pos.reshape(-1)[flat_idx] = (pos[order] - shard_of[order] * p_shard).astype(
        np.int32
    )
    ev_vocab.reshape(-1)[flat_idx] = vocab[order]
    return ev_pos, ev_vocab, p_shard


def bucket_lanes_for_mesh(
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    n_data: int,
    n_pos: int,
    r_sub: Optional[int] = None,
    tile_w: Optional[int] = None,
    body: str = "packed4",
):
    """Route events to (data, pos) shards and pack each shard into the
    lane layout (ops/vote_lanes.py), padded to a common block count, all
    vectorised (the native twin is ``ParsedRuns.lanes_mesh``; this numpy
    packer serves the event path of ``--pure-python``).

    Returns (vb, block_tile (D, S, B) int32, p_shard, n_tiles) with vb
    in the packed4 layout, (D, S, B*r_sub//4, tile_w) int32 with four
    byte-rows per int32 lane, when body='packed4' (default), else
    (D, S, B*r_sub, tile_w) uint8 rows.  No row cap: every event gets a
    lane slot.  Any event->data split gives the same summed counts, so
    events are split round-robin like bucket_events_for_mesh.
    """
    r_sub = r_sub or vote_lanes.R_SUB
    tile_w = tile_w or vote_lanes.TILE_W
    if body == "packed4" and r_sub % 4:
        raise ValueError(f"body packed4 needs r_sub % 4 == 0; got {r_sub}")

    mask = (vocab >= 0) & (vocab < DENSE_V) & (pos >= 0) & (pos < num_positions)
    pos = np.asarray(pos[mask], dtype=np.int64)
    vocab = np.asarray(vocab[mask], dtype=np.uint8)

    p_shard = -(-num_positions // n_pos)
    p_shard = max(tile_w, -(-p_shard // tile_w) * tile_w)
    n_tiles = p_shard // tile_w
    p_total = p_shard * n_pos
    tiles_total = n_tiles * n_pos
    data_of = np.arange(pos.size, dtype=np.int64) % n_data

    # depth per (data slice, global position) in one bincount
    depth = np.bincount(
        data_of * p_total + pos, minlength=n_data * p_total
    ).reshape(n_data, p_total)
    # rows per (d, global tile): tile-max depth rounded up to r_sub
    rows_per = np.maximum(
        r_sub,
        -(-depth.reshape(n_data, tiles_total, tile_w).max(axis=2)
          // r_sub) * r_sub,
    ).astype(np.int64)
    blocks_per = rows_per // r_sub                      # (D, tiles_total)
    blocks_per_shard = blocks_per.reshape(
        n_data, n_pos, n_tiles
    ).sum(axis=2)                                       # (D, S)
    # common padded block count B (geometric + slab rounding of the
    # deepest shard, as vote_lanes._pad_block_count pads one stream)
    b = vote_lanes.geom_pad(int(blocks_per_shard.max()),
                            slab=vote_lanes.MAX_BLOCKS_PER_CALL)

    # block_tile: per (d, s) the local tile index of each emitted block,
    # padded with n_tiles-1 (all vectorised via repeat + group offsets)
    bt_all = np.full((n_data, n_pos, b), n_tiles - 1, dtype=np.int32)
    tile_vals = np.tile(np.arange(n_tiles, dtype=np.int32),
                        n_data * n_pos)
    emitted_tile = np.repeat(tile_vals, blocks_per.reshape(-1))
    shard_starts = np.concatenate(
        ([0], np.cumsum(blocks_per_shard.reshape(-1)))
    )
    shard_of_block = np.repeat(
        np.arange(n_data * n_pos), blocks_per_shard.reshape(-1)
    )
    within = np.arange(emitted_tile.size) - shard_starts[shard_of_block]
    bt_all.reshape(-1)[shard_of_block * b + within] = emitted_tile

    # row base of each (d, global tile) within its shard buffer
    rows_ds = rows_per.reshape(n_data, n_pos, n_tiles)
    row_base = (np.cumsum(rows_ds, axis=2) - rows_ds).reshape(
        n_data, tiles_total
    )

    # occurrence index per (d, global position) via one stable sort
    key = data_of * p_total + pos
    order = np.argsort(key, kind="stable")
    skey = key[order]
    key_start = np.concatenate(([0], np.cumsum(depth.reshape(-1))))
    occ = np.arange(skey.size, dtype=np.int64) - key_start[skey]

    d_s = data_of[order]
    gpos = pos[order]
    tile_g = gpos // tile_w
    col = gpos - tile_g * tile_w
    shard = tile_g // n_tiles
    row = row_base[d_s, tile_g] + occ
    shard_bytes = b * r_sub * tile_w
    base = (d_s * n_pos + shard) * shard_bytes
    vb_flat = np.full(n_data * n_pos * shard_bytes, vote_lanes.PAD_BYTE,
                      dtype=np.uint8)
    if body == "packed4":
        # scatter straight into the packed4 byte addressing (four
        # byte-rows per int32 lane), no re-layout pass
        byte_idx = base + (row >> 2) * (tile_w * 4) + col * 4 + (row & 3)
        vb_flat[byte_idx] = vocab[order]
        vb_all = vb_flat.view(np.int32).reshape(
            n_data, n_pos, b * (r_sub // 4), tile_w
        )
    else:
        vb_flat[base + row * tile_w + col] = vocab[order]
        vb_all = vb_flat.reshape(n_data, n_pos, b * r_sub, tile_w)
    return vb_all, bt_all, p_shard, n_tiles


def _pad_to(arr, n: int, fill, dtype) -> np.ndarray:
    out = np.full(n, fill, dtype=dtype)
    out[: len(arr)] = arr
    return out


def _merge_and_decide(mesh, cell_counts, p_shard: int, valid_thr,
                      invalid_thr, low_depth, orig_id, timer: StageTimer):
    """The tail of both steps: sum each pos column's cell counts over
    the data axis on the device of its data-0 cell, the consensus of
    each position shard there, and the shards concatenated.  Thresholds
    cover the first positions; the rest of the grid's positions are
    pads (low depth, thresholds INT32_MAX, orig_id 0: they keep).
    Returns (counts (8, S*p_shard) int32 tensor on the device of cell
    (0, 0), new_id and status (S*p_shard,) int32 numpy)."""
    n_data, n_pos = mesh.shape
    p_total = p_shard * n_pos
    thr = (_pad_to(valid_thr, p_total, _I32MAX, np.int32),
           _pad_to(invalid_thr, p_total, _I32MAX, np.int32),
           _pad_to(low_depth, p_total, True, bool),
           _pad_to(orig_id, p_total, 0, np.int32))
    counts, new_ids, statuses = [], [], []
    for s in range(n_pos):
        dev = mesh.devices[0, s]
        with timer.stage("data_sum"):
            total = cell_counts[0][s]
            for d in range(1, n_data):
                total = total + cell_counts[d][s].to(dev)
        with timer.stage("upload"):
            lo, hi = s * p_shard, (s + 1) * p_shard
            args = [torch.from_numpy(a[lo:hi]).to(dev) for a in thr]
        with timer.stage("consensus"):
            new_id, status = consensus_dense_core(total, *args)
        counts.append(total)
        new_ids.append(new_id)
        statuses.append(status)
    with timer.stage("fetch"):
        new_id = np.concatenate([t.cpu().numpy() for t in new_ids])
        status = np.concatenate([t.cpu().numpy() for t in statuses])
    head = mesh.devices[0, 0]
    return (torch.cat([c.to(head) for c in counts], dim=1), new_id,
            status)


def sharded_step(mesh, ev_pos: np.ndarray, ev_vocab: np.ndarray,
                 p_shard: int, valid_thr, invalid_thr, low_depth, orig_id,
                 timer: Optional[StageTimer] = None):
    """The scatter step (the JAX package's make_sharded_polish_step):
    cell (d, s) adds its bucketed events (bucket_events_for_mesh) into
    an (8, p_shard) int32 tile on its device with the drop semantics of
    ``.at[].add(mode="drop")``, then the data-axis sum and the
    consensus.  Returns what _merge_and_decide returns."""
    timer = timer if timer is not None else StageTimer()
    n_data, n_pos = mesh.shape
    cells = []
    for d in range(n_data):
        row = []
        for s in range(n_pos):
            dev = mesh.devices[d, s]
            with timer.stage("upload"):
                p = torch.from_numpy(ev_pos[d, s]).to(dev)
                v = torch.from_numpy(ev_vocab[d, s]).to(dev)
            with timer.stage("scatter"):
                tile = torch.zeros((DENSE_V, p_shard), dtype=torch.int32,
                                   device=dev)
                row.append(scatter_add_drop(tile, v, p))
        cells.append(row)
    return _merge_and_decide(mesh, cells, p_shard, valid_thr, invalid_thr,
                             low_depth, orig_id, timer)


def sharded_step_lanes(mesh, vb: np.ndarray, block_tile: np.ndarray,
                       p_shard: int, n_tiles: int, valid_thr, invalid_thr,
                       low_depth, orig_id, r_sub: Optional[int] = None,
                       tile_w: Optional[int] = None, body: str = "packed4",
                       timer: Optional[StageTimer] = None):
    """The lanes step (the JAX package's make_sharded_polish_step_lanes):
    cell (d, s) uploads its lane blocks ``vb[d, s]`` and block map
    ``block_tile[d, s]`` (a mesh pack: bucket_lanes_for_mesh or
    ParsedRuns.lanes_mesh) and counts them with kernel A on its device
    (``lanes_counts``: one launch per cell, whatever its block count;
    the plain version on a CPU cell), trimmed to p_shard; then the
    data-axis sum and the consensus.  Returns what _merge_and_decide
    returns."""
    timer = timer if timer is not None else StageTimer()
    r_sub = r_sub or vote_lanes.R_SUB
    tile_w = tile_w or vote_lanes.TILE_W
    n_data, n_pos = mesh.shape
    if vb.shape[:2] != (n_data, n_pos) or block_tile.shape[:2] != (
            n_data, n_pos):
        raise ValueError(f"mesh pack {vb.shape[:2]} / {block_tile.shape[:2]}"
                         f" does not match the {n_data}x{n_pos} grid")
    cells = []
    for d in range(n_data):
        row = []
        for s in range(n_pos):
            dev = mesh.devices[d, s]
            with timer.stage("upload"):
                d_vb = torch.from_numpy(np.ascontiguousarray(vb[d, s])).to(dev)
                d_bt = torch.from_numpy(
                    np.ascontiguousarray(block_tile[d, s])).to(dev)
            with timer.stage("kernel_a"):
                counts = lanes_counts(d_vb, d_bt, n_tiles, r_sub, tile_w,
                                      body)
            row.append(counts[:, :p_shard])
        cells.append(row)
    return _merge_and_decide(mesh, cells, p_shard, valid_thr, invalid_thr,
                             low_depth, orig_id, timer)


def _trimmed(result, num_positions: int):
    counts, new_id, status = result
    return (counts[:, :num_positions].cpu().numpy(), new_id[:num_positions],
            status[:num_positions])


def sharded_vote_consensus(
    mesh,
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    valid_thr: np.ndarray,
    invalid_thr: np.ndarray,
    low_depth: np.ndarray,
    orig_id: np.ndarray,
    timer: Optional[StageTimer] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sharded vote + consensus of one contig by scatter: buckets the
    events, runs sharded_step and trims to num_positions.  Returns
    (counts, new_id, status) as numpy."""
    n_data, n_pos = mesh.shape
    ev_pos, ev_vocab, p_shard = bucket_events_for_mesh(
        pos, vocab, num_positions, n_data, n_pos
    )
    return _trimmed(sharded_step(mesh, ev_pos, ev_vocab, p_shard, valid_thr,
                                 invalid_thr, low_depth, orig_id, timer),
                    num_positions)


def sharded_vote_consensus_lanes(
    mesh,
    pos: np.ndarray,
    vocab: np.ndarray,
    num_positions: int,
    valid_thr: np.ndarray,
    invalid_thr: np.ndarray,
    low_depth: np.ndarray,
    orig_id: np.ndarray,
    timer: Optional[StageTimer] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Like sharded_vote_consensus, but each cell votes through kernel A
    on its share of the numpy mesh pack (bucket_lanes_for_mesh)."""
    timer = timer if timer is not None else StageTimer()
    n_data, n_pos = mesh.shape
    with timer.stage("pack"):
        vb, bt, p_shard, n_tiles = bucket_lanes_for_mesh(
            pos, vocab, num_positions, n_data, n_pos
        )
    return _trimmed(sharded_step_lanes(mesh, vb, bt, p_shard, n_tiles,
                                       valid_thr, invalid_thr, low_depth,
                                       orig_id, timer=timer),
                    num_positions)
