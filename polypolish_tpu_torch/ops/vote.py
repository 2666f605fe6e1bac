"""Vote accumulation: event stream -> (8, P) dense count tensor + f64
depth (counterpart of polypolish_tpu/ops/vote.py).

- **depth** (f64, order-sensitive): ``np.bincount(pos, weights=w)`` is
  a sequential C loop over the event stream, the reference's additions
  in the reference's order — kept on the host.
- **dense counts** (integers, exactly associative), three
  interchangeable backends of ``count_votes``:
    * ``host``   — numpy bincount
    * ``xla``    — ``dense_counts_xla``, a torch scatter-add on
      ``device`` (the JAX package leaves this one to XLA, so it is
      plain torch here, no hand kernel)
    * ``device`` — the chunk vote kernel (``dense_counts_chunks``; the
      JAX package's ``pallas``)
- **sparse counts** (vocab ids >= 8): host-side unique/count.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from polypolish_tpu_torch.vocab import DENSE_V

SparseCounts = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (pos, vocab_id, count)

BACKENDS = ("host", "xla", "device")


def scatter_add_drop(counts: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """``counts[rows, cols] += 1`` in place with the semantics of JAX's
    ``counts.at[rows, cols].add(1, mode="drop")``: an index in [-n, 0)
    wraps Python-style, any other index outside [0, n) drops its event
    (``index_put_`` alone has no drop mode, and a negative index would
    wrap)."""
    n_rows, n_cols = counts.shape
    rows = rows.to(torch.int64)
    cols = cols.to(torch.int64)
    rows = torch.where(rows < 0, rows + n_rows, rows)
    cols = torch.where(cols < 0, cols + n_cols, cols)
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    rows, cols = rows[keep], cols[keep]
    counts.index_put_((rows, cols),
                      torch.ones_like(rows, dtype=counts.dtype),
                      accumulate=True)
    return counts


def depth_host(pos: np.ndarray, weight: np.ndarray,
               num_positions: int) -> np.ndarray:
    """Per-position f64 depth, sequential in stream order (bit-exact)."""
    if pos.size == 0:
        return np.zeros(num_positions, dtype=np.float64)
    return np.bincount(pos, weights=weight, minlength=num_positions)


def dense_counts_host(pos: np.ndarray, vocab: np.ndarray,
                      num_positions: int) -> np.ndarray:
    """(8, P) int32 dense-tier counts via numpy bincount, one vocab row
    at a time (O(P) temporaries)."""
    counts = np.zeros((DENSE_V, num_positions), dtype=np.int32)
    for v in range(DENSE_V):
        vpos = pos[vocab == v]
        if vpos.size:
            counts[v] = np.bincount(vpos, minlength=num_positions).astype(
                np.int32, copy=False
            )
    return counts


def dense_counts_xla(pos: torch.Tensor, vocab: torch.Tensor,
                     num_positions: int) -> torch.Tensor:
    """(8, P) int32 dense counts by scatter-add on the tensors' device.
    Sparse-tier and padding events (vocab outside [0, 8), pos < 0) are
    routed to the out-of-range column ``num_positions`` and dropped, as
    are positions >= P."""
    ok = (vocab >= 0) & (vocab < DENSE_V) & (pos >= 0)
    p = torch.where(ok, pos, num_positions)
    v = torch.where(ok, vocab, 0)
    counts = torch.zeros((DENSE_V, num_positions), dtype=torch.int32,
                         device=pos.device)
    return scatter_add_drop(counts, v, p)


def sparse_counts_host(pos: np.ndarray, vocab: np.ndarray) -> SparseCounts:
    """Host counts for sparse-tier events (vocab id >= DENSE_V)."""
    mask = vocab >= DENSE_V
    spos = pos[mask]
    sv = vocab[mask]
    if spos.size == 0:
        empty = np.empty((0,), dtype=np.int64)
        return empty, empty, empty
    keys = spos.astype(np.int64) * (2**31) + sv.astype(np.int64)
    uk, cnt = np.unique(keys, return_counts=True)
    return uk // (2**31), uk % (2**31), cnt


def count_votes(
    pos: np.ndarray,
    vocab: np.ndarray,
    weight: np.ndarray,
    num_positions: int,
    backend: str = "host",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, SparseCounts]:
    """Full vote accumulation for one contig: (dense_counts (8, P) int32
    numpy, depth (P,) f64, sparse_counts).  ``device`` is the torch
    device of the xla and device backends."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown vote backend: {backend}")
    depth = depth_host(pos, weight, num_positions)
    sparse = sparse_counts_host(pos, vocab)
    if backend == "host":
        counts = dense_counts_host(pos, vocab, num_positions)
    elif backend == "xla":
        counts = dense_counts_xla(
            torch.from_numpy(np.asarray(pos, np.int64)).to(device),
            torch.from_numpy(np.asarray(vocab, np.int64)).to(device),
            num_positions,
        ).cpu().numpy()
    else:
        from polypolish_tpu_torch.ops.vote_chunks import dense_counts_chunks

        counts = dense_counts_chunks(pos, vocab, num_positions,
                                     device=device).cpu().numpy()
    return counts, depth, sparse
