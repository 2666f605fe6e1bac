"""Insert-size / pair-orientation model of the ``filter`` subcommand
(counterpart of polypolish_tpu/ops/pairfilter.py; reference:
filter.rs:148-377).

An alignment pair's *orientation* is one of fr/rf/ff/rr, from the strand
bits and the read-start positions (the ref-end position on the reverse
strand); its *insert size* is max - min over the four alignment
endpoints.  Thresholds come from a nearest-rank percentile over the
insert sizes of uniquely-mapped pairs.

The pass rule is evaluated as a flat (alignment x pair-alignment) grid,
then reduced per alignment with a segment-any: in numpy on int64
columns (``good_pair_mask_numpy``), or in torch on int32 tensors on the
grid's device (``good_pair_mask``, the JAX package's jitted
``_good_pair_mask_jax_impl``; models/pairscreen.py fuses it with the
reduction).
"""

from __future__ import annotations

import numpy as np
import torch

from polypolish_tpu_torch.errors import quit_with_error

ORIENTATION_NAMES = ("fr", "rf", "ff", "rr")
FR, RF, FF, RR = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Scalar versions (threshold learning + unit tests)
# ---------------------------------------------------------------------------

def orientation_scalar(
    flags_1: int, start_1: int, end_1: int,
    flags_2: int, start_2: int, end_2: int,
) -> int:
    """Pair orientation code (filter.rs:189-209)."""
    fwd_1 = (flags_1 & 16) == 0
    fwd_2 = (flags_2 & 16) == 0
    pos_1 = start_1 if fwd_1 else end_1
    pos_2 = start_2 if fwd_2 else end_2
    if fwd_1 != fwd_2:
        if pos_1 < pos_2:
            return FR if fwd_1 else RF
        return FR if fwd_2 else RF
    if fwd_1:  # both forward
        return FF if pos_1 < pos_2 else RR
    return FF if pos_2 < pos_1 else RR  # both reverse


def insert_size_scalar(start_1: int, end_1: int, start_2: int, end_2: int) -> int:
    """max - min over the four endpoints (filter.rs:212-218)."""
    return max(start_1, end_1, start_2, end_2) - min(start_1, end_1, start_2, end_2)


def get_percentile(sorted_sizes: np.ndarray, percentile: float) -> int:
    """Nearest-rank percentile on a pre-sorted array (filter.rs:249-259)."""
    n = len(sorted_sizes)
    if n == 0:
        return 0
    fraction = percentile / 100.0
    rank = max(int(np.ceil(fraction * n)), 1)
    if rank - 1 >= n:
        return 0
    return int(sorted_sizes[rank - 1])


def get_percentile_name(p: float) -> str:
    """Ordinal percentile label (filter.rs:262-270)."""
    p_str = _rust_f64_display(p)
    if p_str.endswith("1") and p != 11.0:
        return f"{p_str}st percentile"
    if p_str.endswith("2") and p != 12.0:
        return f"{p_str}nd percentile"
    if p_str.endswith("3") and p != 13.0:
        return f"{p_str}rd percentile"
    return f"{p_str}th percentile"


def _rust_f64_display(x: float) -> str:
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def auto_determine_orientation(counts_by_orientation) -> int:
    """Unique argmax over pair counts, else fatal (filter.rs:238-246).

    ``counts_by_orientation``: sequence of 4 ints indexed fr/rf/ff/rr.
    """
    max_count = max(counts_by_orientation)
    winners = [
        i for i in range(4) if counts_by_orientation[i] == max_count
    ]
    if len(winners) != 1:
        quit_with_error("could not automatically determine read pair orientation")
    return winners[0]


# ---------------------------------------------------------------------------
# Vectorised versions (bulk threshold learning + pass-rule grids)
# ---------------------------------------------------------------------------

def orientation_vec(
    flags_1, start_1, end_1, flags_2, start_2, end_2
) -> np.ndarray:
    """Vectorised orientation codes over parallel arrays."""
    fwd_1 = (flags_1 & 16) == 0
    fwd_2 = (flags_2 & 16) == 0
    pos_1 = np.where(fwd_1, start_1, end_1)
    pos_2 = np.where(fwd_2, start_2, end_2)
    opp = fwd_1 != fwd_2
    first_fwd = np.where(pos_1 < pos_2, fwd_1, fwd_2)
    orient_opp = np.where(first_fwd, FR, RF)
    fwd_order = np.where(fwd_1, pos_1 < pos_2, pos_2 < pos_1)
    orient_same = np.where(fwd_order, FF, RR)
    return np.where(opp, orient_opp, orient_same).astype(np.int32)


def insert_size_vec(start_1, end_1, start_2, end_2) -> np.ndarray:
    hi = np.maximum(np.maximum(start_1, end_1), np.maximum(start_2, end_2))
    lo = np.minimum(np.minimum(start_1, end_1), np.minimum(start_2, end_2))
    return (hi - lo).astype(np.int64)


def good_pair_mask_numpy(
    ref_a, flags_a, start_a, end_a,
    ref_p, flags_p, start_p, end_p,
    low: int, high: int, correct_orientation: int,
) -> np.ndarray:
    """Elementwise "makes a good pair" mask over parallel pair arrays
    (the body of filter.rs:368-374); insert sizes in int64."""
    same_ref = ref_a == ref_p
    insert = insert_size_vec(start_a, end_a, start_p, end_p)
    orient = orientation_vec(flags_a, start_a, end_a, flags_p, start_p, end_p)
    return same_ref & (low <= insert) & (insert <= high) & (orient == correct_orientation)


def good_pair_mask(
    ref_a: torch.Tensor, flags_a: torch.Tensor, start_a: torch.Tensor,
    end_a: torch.Tensor,
    ref_p: torch.Tensor, flags_p: torch.Tensor, start_p: torch.Tensor,
    end_p: torch.Tensor,
    low: int, high: int, correct_orientation: int,
) -> torch.Tensor:
    """good_pair_mask_numpy in torch on the tensors' device: the
    counterpart of the JAX package's _good_pair_mask_jax_impl.  The
    columns are int32 tensors, as the JAX step casts them, so the insert
    size is an int32 difference."""
    for t in (ref_a, flags_a, start_a, end_a, ref_p, flags_p, start_p,
              end_p):
        if t.dtype != torch.int32:
            raise TypeError(f"pair grid columns are int32; got {t.dtype}")
    fwd_1 = (flags_a & 16) == 0
    fwd_2 = (flags_p & 16) == 0
    pos_1 = torch.where(fwd_1, start_a, end_a)
    pos_2 = torch.where(fwd_2, start_p, end_p)
    opp = fwd_1 != fwd_2
    first_fwd = torch.where(pos_1 < pos_2, fwd_1, fwd_2)
    orient_opp = torch.where(first_fwd, FR, RF)
    fwd_order = torch.where(fwd_1, pos_1 < pos_2, pos_2 < pos_1)
    orient_same = torch.where(fwd_order, FF, RR)
    orient = torch.where(opp, orient_opp, orient_same)

    hi = torch.maximum(torch.maximum(start_a, end_a),
                       torch.maximum(start_p, end_p))
    lo = torch.minimum(torch.minimum(start_a, end_a),
                       torch.minimum(start_p, end_p))
    insert = hi - lo
    return ((ref_a == ref_p)
            & (insert >= low)
            & (insert <= high)
            & (orient == correct_orientation))


def segment_any(mask: np.ndarray, segment_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """any() of mask per segment (segment_ids must be >= 0, < num_segments)."""
    out = np.zeros(num_segments, dtype=bool)
    np.logical_or.at(out, segment_ids, mask)
    return out
