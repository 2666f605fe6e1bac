"""One-shot paired-end workflow: filter, then polish (counterpart of
polypolish_tpu/pipeline/full.py).

The reference documents this as a two-command pipeline (its README:
``polypolish filter`` then ``polypolish polish``); this module runs both
stages with a temporary directory for the intermediate tagged SAMs.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import List, Optional, TextIO, Tuple


def polish_paired(
    assembly: str,
    in1: str,
    in2: str,
    orientation: str = "auto",
    low: float = 0.1,
    high: float = 99.9,
    debug: Optional[str] = None,
    fraction_invalid: float = 0.2,
    fraction_valid: float = 0.5,
    max_errors: int = 10,
    min_depth: int = 5,
    careful: bool = False,
    out: Optional[TextIO] = None,
    backend: str = "device",
    use_native: bool = True,
    n_threads: Optional[int] = None,
    pod_shards: int = 0,
    keep_filtered: Optional[str] = None,
    kernel_variant: Optional[str] = None,
    device="cuda",
) -> List[Tuple[str, int]]:
    """Filter the pair, then polish with the filtered alignments.

    ``backend``, ``kernel_variant``, ``use_native`` and ``device`` go to
    the port's polish; ``device`` also runs the filter's device grid
    step.  pod_shards: when > 1, the polish stage runs with its SAM
    ingest sharded over that many byte-range shards (the polish
    subcommand's --pod-shards; byte-identical to unsharded).
    keep_filtered: optional directory to keep the filtered SAMs in
    (otherwise they live in a temporary directory removed afterwards).
    """
    from polypolish_tpu_torch.pipeline.filtering import filter_pairs
    from polypolish_tpu_torch.pipeline.polish import polish

    if out is None:
        out = sys.stdout

    workdir = keep_filtered or tempfile.mkdtemp(prefix="polypolish_tpu_")
    os.makedirs(workdir, exist_ok=True)
    out1 = os.path.join(workdir, "filtered_1.sam")
    out2 = os.path.join(workdir, "filtered_2.sam")
    try:
        filter_pairs(in1, in2, out1, out2, orientation, low, high,
                     device=device)
        if pod_shards and pod_shards > 1:
            from polypolish_tpu_torch.pipeline.pod import (
                polish_pod,
                refuse_or_note,
            )

            refuse_or_note(use_native, backend)
            return polish_pod(
                debug, fraction_invalid, fraction_valid, max_errors,
                min_depth, careful, assembly, [out1, out2], pod_shards,
                out=out, n_threads=n_threads,
            )
        return polish(
            debug, fraction_invalid, fraction_valid, max_errors, min_depth,
            careful, assembly, [out1, out2],
            out=out, backend=backend, use_native=use_native,
            n_threads=n_threads, device=device,
            kernel_variant=kernel_variant,
        )
    finally:
        if keep_filtered is None:
            for p in (out1, out2):
                try:
                    os.remove(p)
                except OSError:
                    pass
            try:
                os.rmdir(workdir)
            except OSError:
                pass
