"""Consensus: per-position polishing decision (counterpart of
polypolish_tpu/ops/consensus.py).

Reference: pileup.rs:67-134 (``get_polished_seq``) + misc.rs:204-215.

Decision rule per position:
  valid_threshold   = max(min_depth, bankers_round(depth * fraction_valid))
  invalid_threshold = bankers_round(depth * fraction_invalid)
  each candidate sequence is *valid* (count >= valid_threshold) or
  *intermediate* (valid > count >= invalid_threshold).
  A/C/G/T always participate (even at count 0); every other sequence
  participates only when its count >= 1 (it exists in the reference's
  HashMap).  Outcomes:
    depth < min_depth                  -> LOW_DEPTH   (keep)
    1 valid, 0 intermediate            -> adopt (CHANGED iff != original)
    1 valid, >=1 intermediate          -> TOO_CLOSE   (keep)
    0 valid                            -> NONE        (keep)
    >1 valid                           -> MULTIPLE    (keep)

Split of work:
- **Thresholds** are order-sensitive f64 arithmetic -> host numpy (or
  the C++ fold), bit-exact with the reference.  O(P) elementwise.
- **The decision** is integer compares over the (8, P) dense count
  tensor -> torch on the device (``consensus_dense_core``), or numpy.
- Positions with sparse-tier votes (multi-base insertions etc.) are
  recomputed on the host with the full candidate list and overridden.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from polypolish_tpu_torch.utils.rounding import (
    bankers_rounding,
    bankers_rounding_vec,
)
from polypolish_tpu_torch.vocab import DENSE_V

# Status codes (debug strings per pileup.rs:156-163).
ST_KEPT = 0
ST_CHANGED = 1
ST_LOW_DEPTH = 2
ST_NONE = 3
ST_MULTIPLE = 4
ST_TOO_CLOSE = 5

STATUS_STRINGS = ("kept", "changed", "low_depth", "none", "multiple", "too_close")

_I32_MAX = np.int32(2**31 - 1)


def compute_thresholds(
    depth: np.ndarray,
    min_depth: int,
    fraction_valid: float,
    fraction_invalid: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side f64 threshold pass, bit-exact vs the reference.

    Returns (valid_thr:int32, invalid_thr:int32, low_depth:bool) arrays.
    """
    depth = np.asarray(depth, dtype=np.float64)
    valid = np.maximum(
        np.int64(min_depth), bankers_rounding_vec(depth * fraction_valid)
    )
    invalid = bankers_rounding_vec(depth * fraction_invalid)
    low = depth < float(min_depth)
    valid = np.minimum(valid, np.int64(_I32_MAX)).astype(np.int32)
    invalid = np.minimum(invalid, np.int64(_I32_MAX)).astype(np.int32)
    return valid, invalid, low


# Dense rows that always participate in consensus: A, C, G, T (ids 1..4).
_ACGT_ROWS = np.zeros((DENSE_V, 1), dtype=bool)
_ACGT_ROWS[1:5] = True


def consensus_dense_core(counts: torch.Tensor, valid_thr: torch.Tensor,
                         invalid_thr: torch.Tensor, low_depth: torch.Tensor,
                         orig_id: torch.Tensor):
    """Device consensus over the dense tier (torch, on the tensors'
    device).

    Args:
      counts:      (8, P) int32 vote counts (rows = dense vocab ids).
      valid_thr:   (P,) int32.
      invalid_thr: (P,) int32.
      low_depth:   (P,) bool (depth < min_depth, computed in f64 on host).
      orig_id:     (P,) int32 vocab id of the original assembly base.

    Returns (new_id:(P,) int32, status:(P,) int32).
    """
    acgt = torch.from_numpy(_ACGT_ROWS).to(counts.device)
    participate = acgt | (counts > 0)
    is_valid = participate & (counts >= valid_thr[None, :])
    is_inter = participate & ~is_valid & (counts >= invalid_thr[None, :])
    n_valid = is_valid.sum(dim=0, dtype=torch.int32)
    n_inter = is_inter.sum(dim=0, dtype=torch.int32)
    # argmax does not take bool; on uint8 it returns the FIRST maximal
    # row, i.e. the first valid id (consensus.py argmax semantics)
    valid_id = is_valid.to(torch.uint8).argmax(dim=0).to(torch.int32)

    one_valid = n_valid == 1
    adopt = ~low_depth & one_valid & (n_inter == 0)
    new_id = torch.where(adopt, valid_id, orig_id)

    def const(v):
        return torch.tensor(v, dtype=torch.int32, device=counts.device)

    status = torch.where(
        low_depth,
        const(ST_LOW_DEPTH),
        torch.where(
            one_valid,
            torch.where(
                n_inter > 0,
                const(ST_TOO_CLOSE),
                torch.where(valid_id != orig_id, const(ST_CHANGED),
                            const(ST_KEPT)),
            ),
            torch.where(n_valid == 0, const(ST_NONE), const(ST_MULTIPLE)),
        ),
    )
    return new_id.to(torch.int32), status


def consensus_dense_numpy(counts, valid_thr, invalid_thr, low_depth, orig_id):
    """Pure-numpy mirror of consensus_dense_core (cross-check).

    Streams over the 8 vocab rows so peak temporaries are O(P), not
    O(8P)."""
    counts = np.asarray(counts, dtype=np.int32)
    p = counts.shape[1]
    n_valid = np.zeros(p, dtype=np.int32)
    n_inter = np.zeros(p, dtype=np.int32)
    valid_id = np.zeros(p, dtype=np.int32)
    for v in range(counts.shape[0]):
        cv = counts[v]
        part = (cv > 0) if not _ACGT_ROWS[v, 0] else None
        isv = cv >= valid_thr
        if part is not None:
            isv &= part
        # first valid row wins (argmax-over-rows semantics)
        valid_id = np.where(isv & (n_valid == 0), v, valid_id)
        n_valid += isv
        isi = cv >= invalid_thr
        if part is not None:
            isi &= part
        n_inter += isi & ~isv

    one_valid = n_valid == 1
    adopt = (~low_depth) & one_valid & (n_inter == 0)
    new_id = np.where(adopt, valid_id, orig_id).astype(np.int32)
    status = np.where(
        low_depth,
        ST_LOW_DEPTH,
        np.where(
            one_valid,
            np.where(
                n_inter > 0,
                ST_TOO_CLOSE,
                np.where(valid_id != orig_id, ST_CHANGED, ST_KEPT),
            ),
            np.where(n_valid == 0, ST_NONE, ST_MULTIPLE),
        ),
    ).astype(np.int32)
    return new_id, status


def consensus_sparse_override(
    counts,
    sp_pos: np.ndarray,
    sp_vid: np.ndarray,
    sp_cnt: np.ndarray,
    valid_thr: np.ndarray,
    invalid_thr: np.ndarray,
    depth: np.ndarray,
    min_depth: int,
    orig_id: np.ndarray,
    new_id: np.ndarray,
    status: np.ndarray,
    pregathered: bool = False,
) -> np.ndarray:
    """Vectorised re-decision for every position that has sparse-tier
    votes, overriding ``new_id``/``status`` in place (the dense-only
    pass could not see those candidates).  Exactly the candidate-list
    rule of pileup.rs:67-134.

    sp_pos must be sorted ascending with entries grouped by position
    (the order fold/sparse produce).  Returns the unique positions.

    ``counts`` is the full (8, P) numpy array, or — with
    ``pregathered=True`` — the (8, n_unique) column block
    ``counts[:, np.unique(sp_pos)]`` that the caller gathered on the
    device, so that only those columns cross to the host."""
    upos, seg_start = np.unique(sp_pos, return_index=True)
    seg_id = np.searchsorted(upos, sp_pos)
    vt = valid_thr[upos].astype(np.int64)
    it = invalid_thr[upos].astype(np.int64)
    cols = np.asarray(counts) if pregathered else np.asarray(counts)[:, upos]
    if cols.shape != (DENSE_V, upos.size):
        raise ValueError(
            f"sparse override columns {cols.shape} != "
            f"({DENSE_V}, {upos.size})"
        )
    participate = _ACGT_ROWS | (cols > 0)
    isv_d = participate & (cols >= vt[None, :])
    isi_d = participate & ~isv_d & (cols >= it[None, :])
    n_valid = isv_d.sum(axis=0).astype(np.int64)
    n_inter = isi_d.sum(axis=0).astype(np.int64)
    dense_has_valid = n_valid > 0
    first_valid_dense = np.argmax(isv_d, axis=0).astype(np.int64)

    cnt = sp_cnt.astype(np.int64)
    e_v = cnt >= vt[seg_id]
    e_i = (~e_v) & (cnt >= it[seg_id])
    n_valid += np.bincount(seg_id, weights=e_v, minlength=upos.size
                           ).astype(np.int64)
    n_inter += np.bincount(seg_id, weights=e_i, minlength=upos.size
                           ).astype(np.int64)
    # the (single) valid sparse vid per segment; only consumed when the
    # total valid count is exactly 1, so any reduction that surfaces it
    # works — max over (valid ? vid : -1)
    sv = np.where(e_v, sp_vid.astype(np.int64), -1)
    seg_valid_vid = np.maximum.reduceat(sv, seg_start)
    valid_vid = np.where(dense_has_valid, first_valid_dense, seg_valid_vid)

    ld = depth[upos] < float(min_depth)
    ou = orig_id[upos].astype(np.int64)
    one = n_valid == 1
    adopt = (~ld) & one & (n_inter == 0)
    nid_u = np.where(adopt, valid_vid, ou).astype(np.int32)
    st_u = np.where(
        ld,
        ST_LOW_DEPTH,
        np.where(
            one,
            np.where(
                n_inter > 0,
                ST_TOO_CLOSE,
                np.where(nid_u != ou, ST_CHANGED, ST_KEPT),
            ),
            np.where(n_valid == 0, ST_NONE, ST_MULTIPLE),
        ),
    ).astype(np.int32)
    new_id[upos] = nid_u
    status[upos] = st_u
    return upos


def consensus_one_position(
    candidates: List[Tuple[int, int]],
    orig_id: int,
    depth: float,
    min_depth: int,
    fraction_valid: float,
    fraction_invalid: float,
) -> Tuple[int, int, int, int]:
    """Scalar consensus with an explicit candidate list: the
    per-position rule (pileup.rs:67-134) that the vectorised passes
    reproduce.  ``candidates`` is a list of (vocab_id, count); A/C/G/T
    must be present even at count 0, every other entry must have
    count >= 1.

    Returns (new_id, status, valid_thr, invalid_thr).
    """
    valid_thr = max(min_depth, bankers_rounding(depth * fraction_valid))
    invalid_thr = bankers_rounding(depth * fraction_invalid)

    valid_ids = [vid for vid, c in candidates if c >= valid_thr]
    n_inter = sum(
        1 for vid, c in candidates if c < valid_thr and c >= invalid_thr
    )

    new_id = orig_id
    status = ST_KEPT
    if depth < min_depth:
        status = ST_LOW_DEPTH
    elif len(valid_ids) == 1:
        if n_inter > 0:
            status = ST_TOO_CLOSE
        else:
            new_id = valid_ids[0]
            if new_id != orig_id:
                status = ST_CHANGED
    elif len(valid_ids) == 0:
        status = ST_NONE
    else:
        status = ST_MULTIPLE
    return new_id, status, valid_thr, invalid_thr
