"""Device step of the filter pass rule (counterpart of
polypolish_tpu/models/pairscreen.py).

The filter's pass rule (filter.rs:352-377) evaluated as a flat
(alignment x pair-alignment) grid on the grid's device: each entry
checks same reference, insert-size window and orientation
(ops/pairfilter.py ``good_pair_mask``), and a max-reduction over each
alignment's entries ORs the grid back into per-alignment verdicts.
This is an XLA step in the JAX package, not a Pallas kernel, so it is
torch ops here.
"""

from __future__ import annotations

import torch

from polypolish_tpu_torch.ops.pairfilter import good_pair_mask


def pair_screen_step(
    seg_ids: torch.Tensor,
    ref_a: torch.Tensor, flags_a: torch.Tensor, start_a: torch.Tensor,
    end_a: torch.Tensor,
    ref_p: torch.Tensor, flags_p: torch.Tensor, start_p: torch.Tensor,
    end_p: torch.Tensor,
    low: int, high: int, correct_orientation: int,
    no_pair: torch.Tensor, unique_this: torch.Tensor,
    num_alignments: int,
) -> torch.Tensor:
    """Verdicts (num_alignments,) bool for every alignment of one file.

    The grid columns are flat int32 tensors (one entry per candidate
    pair); ``seg_ids`` (sorted) maps each entry to its alignment row,
    and pad entries carry seg_id = num_alignments.  ``no_pair`` and
    ``unique_this`` are the per-alignment shortcuts of
    filter.rs:362-366.  The JAX step's segment_max becomes an "amax"
    scatter into num_alignments + 1 zeroed int32 slots, so an alignment
    with no entry comes out False.  ``pair_screen_step.launches`` counts
    the calls."""
    good = good_pair_mask(ref_a, flags_a, start_a, end_a,
                          ref_p, flags_p, start_p, end_p,
                          low, high, correct_orientation)
    best = torch.zeros(num_alignments + 1, dtype=torch.int32,
                       device=good.device)
    best.scatter_reduce_(0, seg_ids.to(torch.int64), good.to(torch.int32),
                         reduce="amax", include_self=True)
    pair_screen_step.launches += 1
    return no_pair | unique_this | (best[:num_alignments] > 0)


pair_screen_step.launches = 0
