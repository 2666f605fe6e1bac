"""The ``filter`` workflow (counterpart of
polypolish_tpu/pipeline/filtering.py; reference: filter.rs:26-377).

Pre-screens paired-end SAM files: learns the correct pair orientation
and insert-size thresholds from uniquely-mapped pairs, then re-streams
both inputs, tagging discordant alignments with ``ZP:Z:fail`` (which the
polish pass treats as a QC failure, alignment.rs:72-74).

Both inputs (plain, gzip or BAM) are read by the native pair
quick-parse.  The per-alignment pass rule (filter.rs:352-377) is one
flat (alignment x pair-alignment) grid and a segment-any: numpy for
grids below _DEVICE_GRID_THRESHOLD entries, and at or above it
models/pairscreen.py's ``pair_screen_step`` on ``device`` ("cuda" by
default; "cpu" runs the same torch ops on the CPU).  The outputs are
rewritten by the native re-stream; a ``.gz`` output is its text,
gzip-compressed.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import os
import shutil
import tempfile
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from polypolish_tpu_torch import __version__, log
from polypolish_tpu_torch.errors import quit_with_error
from polypolish_tpu_torch.models.pairscreen import pair_screen_step
from polypolish_tpu_torch.native import binding
from polypolish_tpu_torch.ops import pairfilter
from polypolish_tpu_torch.ops.pairfilter import ORIENTATION_NAMES
from polypolish_tpu_torch.pipeline.polish import resolve_device
from polypolish_tpu_torch.utils.timing import format_duration

# Pair grids of this many entries or more go through the device step
# (the JAX package's _JAX_GRID_THRESHOLD).
_DEVICE_GRID_THRESHOLD = 1_000_000


class _FileAlignments:
    """Column arrays of one SAM file's aligned records, in file order,
    from the native quick-parse; ``line_end`` holds their line-end byte
    offsets, which make the verdict rewrite scan-free."""

    __slots__ = ("flags", "ref_id", "start", "end", "name_idx",
                 "line_end")

    def __init__(self, cols) -> None:
        self.flags = cols["flags"]
        self.ref_id = cols["ref_id"]
        self.start = cols["start"]
        self.end = cols["end"]
        self.name_idx = cols["name_id"]
        self.line_end = cols["line_end"]

    def __len__(self) -> int:
        return len(self.flags)


def filter_pairs(
    in1: str,
    in2: str,
    out1: str,
    out2: str,
    orientation: str = "auto",
    low: float = 0.1,
    high: float = 99.9,
    device="cuda",
) -> Tuple[int, int]:
    """Run the filter workflow; returns (before_count, after_count)."""
    start_time = time.monotonic()
    dev = resolve_device(device)
    check_inputs(in1, in2, out1, out2, low, high)
    starting_message(in1, in2, out1, out2, orientation, low, high)
    files = load_alignments(in1, in2)
    before_count = len(files[0]) + len(files[1])
    low_thr, high_thr, correct_orientation = get_insert_size_thresholds(
        files, orientation, low, high
    )
    after_count = filter_sams(
        in1, in2, out1, out2, files, low_thr, high_thr, correct_orientation,
        dev,
    )
    finished_message(start_time, before_count, after_count)
    return before_count, after_count


def check_inputs(in1, in2, out1, out2, low: float, high: float) -> None:
    """Reference: filter.rs:40-53."""
    if len({in1, in2, out1, out2}) != 4:
        quit_with_error("--in1, --in2, --out1 and --out2 must all have unique values")
    if low <= 0.0 or low >= 50.0:
        quit_with_error("--low must be greater than 0 and less than 50")
    if high <= 50.0 or high >= 100.0:
        quit_with_error("--high must be greater than 50 and less than 100")


def starting_message(in1, in2, out1, out2, orientation, low, high) -> None:
    log.section_header("Starting Polypolish-TPU filter")
    log.explanation(
        "This runs a pre-processing filter on SAM alignments before they "
        "are used to polish. It looks at each read pair and flags "
        "alignments that do not seem to be part of a concordant pair. This "
        "can improve the accuracy Polypolish, especially near the edges of "
        "repeats."
    )
    log.eprint(f"Polypolish-TPU version: v{__version__}")
    log.eprint()
    log.eprint("Input alignments:")
    log.eprint(f"  {in1}")
    log.eprint(f"  {in2}")
    log.eprint()
    log.eprint("Output alignments:")
    log.eprint(f"  {out1}")
    log.eprint(f"  {out2}")
    log.eprint()
    log.eprint("Settings:")
    log.eprint(f"  --orientation {orientation}")
    log.eprint(f"  --low {pairfilter._rust_f64_display(low)}")
    log.eprint(f"  --high {pairfilter._rust_f64_display(high)}")
    log.eprint()


def finished_message(start_time: float, before_count: int, after_count: int) -> None:
    log.section_header("Finished!")
    log.eprint(f"Alignments before filtering: {log.thousands(before_count)}")
    log.eprint(f"Alignments after filtering:  {log.thousands(after_count)}")
    log.eprint()
    log.eprint(f"Time to run: {format_duration(time.monotonic() - start_time)}")
    log.eprint()


def load_alignments(in1: str, in2: str
                    ) -> Tuple[_FileAlignments, _FileAlignments]:
    """Reference: filter.rs:91-145."""
    log.section_header("Loading alignments")
    files = _load_native(in1, in2)
    log.eprint()
    return files


def _load_native(in1: str, in2: str):
    """Both files through the native pair quick-parse (plain, gzip and
    BAM input)."""
    parsed = binding.quick_parse_pair(in1, in2)
    files = []
    for filename, cols in zip((in1, in2), parsed):
        fa = _FileAlignments(cols)
        files.append(fa)
        log.eprint(
            f"{filename}: {log.thousands(len(fa))} alignments from "
            f"{log.thousands(cols['n_names'])} reads"
        )
    if len(files[0]) == 0:
        quit_with_error(f'no alignments found in "{in1}"')
    return files[0], files[1]


def get_insert_size_thresholds(
    files: Tuple[_FileAlignments, _FileAlignments],
    orientation: str,
    low_percentile: float,
    high_percentile: float,
) -> Tuple[int, int, int]:
    """Reference: filter.rs:148-186 (+221-246)."""
    log.section_header("Finding insert size thresholds")
    log.explanation(
        "Read pairs with exactly one alignment per read are used to "
        "determine the orientation and insert size thresholds for the "
        "read set."
    )
    f1, f2 = files
    # Vectorised unique-pair selection: reads with exactly one alignment
    # in each file, same reference (filter.rs:155-167).
    num_names = (
        int(
            max(
                f1.name_idx.max() if len(f1) else -1,
                f2.name_idx.max() if len(f2) else -1,
            )
        )
        + 1
    )
    c1 = np.bincount(f1.name_idx, minlength=num_names)
    c2 = np.bincount(f2.name_idx, minlength=num_names)
    row1 = np.full(num_names, -1, dtype=np.int64)
    row1[f1.name_idx[::-1]] = np.arange(len(f1))[::-1]
    row2 = np.full(num_names, -1, dtype=np.int64)
    row2[f2.name_idx[::-1]] = np.arange(len(f2))[::-1]
    unique = (c1 == 1) & (c2 == 1)
    r1 = row1[unique]
    r2 = row2[unique]
    same_ref = f1.ref_id[r1] == f2.ref_id[r2]
    r1, r2 = r1[same_ref], r2[same_ref]

    codes = pairfilter.orientation_vec(
        f1.flags[r1], f1.start[r1], f1.end[r1],
        f2.flags[r2], f2.start[r2], f2.end[r2],
    )
    sizes_all = pairfilter.insert_size_vec(
        f1.start[r1], f1.end[r1], f2.start[r2], f2.end[r2]
    )
    sizes_by_orientation = [sizes_all[codes == c] for c in range(4)]
    total_unique_pairs = int(r1.shape[0])
    if total_unique_pairs == 0:
        quit_with_error(
            "no one-alignment-per-read pairs available to determine "
            "orientation and insert size thresholds"
        )

    counts = [len(s) for s in sizes_by_orientation]
    for i, oname in enumerate(ORIENTATION_NAMES):
        log.eprint(f"{oname}: {log.thousands(counts[i])} pairs")
    if orientation == "auto":
        code = pairfilter.auto_determine_orientation(counts)
        log.eprint(
            f"\nAutomatically determined correct orientation: "
            f"{ORIENTATION_NAMES[code]}\n"
        )
    else:
        log.eprint(f"\nUser-specified correct orientation: {orientation}\n")
        # An unknown orientation string selects an empty insert-size set
        # and dies with the reference's own downstream fatal, as
        # filter.rs:232-234 and :174-176 do.
        code = (
            ORIENTATION_NAMES.index(orientation)
            if orientation in ORIENTATION_NAMES
            else -1
        )

    sizes = (
        np.sort(np.asarray(sizes_by_orientation[code], dtype=np.int64),
                kind="stable")
        if code >= 0
        else np.empty(0, dtype=np.int64)
    )
    if sizes.size == 0:
        quit_with_error("no read pairs available to determine insert size thresholds")
    low_threshold = pairfilter.get_percentile(sizes, low_percentile)
    high_threshold = pairfilter.get_percentile(sizes, high_percentile)
    log.eprint(
        f"Low threshold:  {low_threshold} "
        f"({pairfilter.get_percentile_name(low_percentile)})"
    )
    log.eprint(
        f"High threshold: {high_threshold} "
        f"({pairfilter.get_percentile_name(high_percentile)})"
    )
    log.eprint()
    return low_threshold, high_threshold, code


def filter_sams(
    in1, in2, out1, out2, files, low: int, high: int,
    correct_orientation: int, device: torch.device,
) -> int:
    """Reference: filter.rs:273-349."""
    log.section_header("Filtering SAM files")
    log.explanation(
        "Read alignments that are part of a good pair (correct orientation "
        "and insert size) pass the filter and are written unaltered to the "
        'output file. Read alignments which are not part of good pair are '
        'written to the output file with a "ZP:Z:fail" tag so Polypolish '
        "will not use them."
    )
    # the two output rewrites are independent and the native re-stream
    # releases the GIL, so they run concurrently; the narrative is
    # printed after both, in reference order
    jobs = []
    for which, (in_f, out_f) in enumerate(((in1, out1), (in2, out2))):
        verdicts = compute_verdicts(files, which, low, high,
                                    correct_orientation, device)
        jobs.append((in_f, out_f, verdicts, files[which].line_end))
    after_count = 0
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(_rewrite_sam_quiet, i, o, v, le)
                   for i, o, v, le in jobs]
        results = [fut.result() for fut in futures]
    for (in_f, _o, _v, _le), (pass_count, fail_count) in zip(jobs, results):
        log.eprint(f"Filtering {in_f}:")
        log.eprint(f"  {log.thousands(pass_count)} pass")
        log.eprint(f"  {log.thousands(fail_count)} fail")
        log.eprint()
        after_count += pass_count
    return after_count


class PairGrid(NamedTuple):
    """One file's pass-rule inputs: the per-alignment shortcuts
    (filter.rs:362-366: no alignment of the mate, or the only alignment
    of its read) and the flat grid of the other alignments, entry e
    pairing this file's row seg[e] with the other file's row
    pair_rows[e] (seg ascending)."""

    no_pair: np.ndarray
    unique_this: np.ndarray
    seg: np.ndarray
    pair_rows: np.ndarray


def pair_grid(this: _FileAlignments, other: _FileAlignments) -> PairGrid:
    n = len(this)
    num_names = int(max(this.name_idx.max() if n else 0,
                        other.name_idx.max() if len(other) else 0)) + 1
    this_count_by_name = np.bincount(this.name_idx, minlength=num_names)
    other_count_by_name = np.bincount(other.name_idx, minlength=num_names)

    # CSR of the other file's rows grouped by name.
    other_order = np.argsort(other.name_idx, kind="stable")
    other_offsets = np.zeros(num_names + 1, dtype=np.int64)
    np.cumsum(other_count_by_name, out=other_offsets[1:])

    reps = other_count_by_name[this.name_idx]  # pair count per alignment
    no_pair = reps == 0
    unique_this = this_count_by_name[this.name_idx] == 1
    reps_need = np.where(no_pair | unique_this, 0, reps)
    seg = np.repeat(np.arange(n), reps_need)
    cum = np.concatenate(([0], np.cumsum(reps_need)))[:-1]
    flat_k = np.arange(seg.size) - np.repeat(cum, reps_need)
    pair_rows = other_order[other_offsets[this.name_idx[seg]] + flat_k]
    return PairGrid(no_pair, unique_this, seg, pair_rows)


def compute_verdicts(
    files, which: int, low: int, high: int, correct_orientation: int,
    device: torch.device,
) -> np.ndarray:
    """Pass/fail for every aligned record of one file, in file order
    (reference pass rules: filter.rs:352-377)."""
    this, other = files[which], files[1 - which]
    n = len(this)
    if n == 0:
        return np.zeros(0, dtype=bool)
    grid = pair_grid(this, other)
    seg, rows = grid.seg, grid.pair_rows
    verdict = grid.no_pair | grid.unique_this
    if seg.size == 0:
        return verdict
    if seg.size >= _DEVICE_GRID_THRESHOLD:
        # the whole grid step on the device, on int32 columns as the
        # JAX package's step casts them
        def i32(a):
            return torch.from_numpy(a.astype(np.int32)).to(device)

        return pair_screen_step(
            i32(seg),
            i32(this.ref_id[seg]), i32(this.flags[seg]),
            i32(this.start[seg]), i32(this.end[seg]),
            i32(other.ref_id[rows]), i32(other.flags[rows]),
            i32(other.start[rows]), i32(other.end[rows]),
            low, high, correct_orientation,
            torch.from_numpy(grid.no_pair).to(device),
            torch.from_numpy(grid.unique_this).to(device),
            num_alignments=n,
        ).cpu().numpy()
    good = pairfilter.good_pair_mask_numpy(
        this.ref_id[seg], this.flags[seg], this.start[seg], this.end[seg],
        other.ref_id[rows], other.flags[rows], other.start[rows],
        other.end[rows],
        low, high, correct_orientation,
    )
    return verdict | pairfilter.segment_any(np.asarray(good, dtype=bool),
                                            seg, n)


def _rewrite_sam_quiet(in_filename: str, out_filename: str,
                       verdicts: np.ndarray, line_end=None):
    """Re-stream one input natively, writing pass-through or
    ZP:Z:fail-tagged lines; returns (pass_count, fail_count) with no
    stderr output (so the two files can be rewritten on two threads).
    A ``.gz`` output gets the re-stream's text written to a temporary
    file beside it, then gzip-compressed into place."""
    if not str(out_filename).endswith(".gz"):
        return binding.rewrite_sam_native(in_filename, out_filename,
                                          verdicts, line_end=line_end)
    try:
        fd, tmp = tempfile.mkstemp(
            prefix=".filter-", suffix=".sam",
            dir=os.path.dirname(os.path.abspath(out_filename)))
        os.close(fd)
    except OSError:
        quit_with_error(f'unable to write alignments to "{out_filename}"')
    try:
        counts = binding.rewrite_sam_native(in_filename, tmp, verdicts,
                                            line_end=line_end)
        try:
            with open(tmp, "rb") as src, gzip.open(out_filename, "wb") as dst:
                shutil.copyfileobj(src, dst, 1 << 20)
        except OSError:
            quit_with_error(
                f'unable to write alignments to "{out_filename}"')
        return counts
    finally:
        os.remove(tmp)
