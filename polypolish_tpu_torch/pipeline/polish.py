"""The ``polish`` workflow (counterpart of
polypolish_tpu/pipeline/polish.py; reference: polish.rs:26-300).

Host orchestration: validate options, load the assembly, parse every
SAM file with the native run engine (or, with ``use_native=False``, the
pure-Python reader of ``--pure-python``), then per contig compute the
votes and the consensus and emit the polished FASTA to stdout (stats to
stderr, optional per-base debug TSV).

Four backends (the JAX package's ``pallas`` is the port's
``device``):

- ``device`` (default): f64 depth and thresholds folded in C++ on the
  host, then votes and consensus on ``device`` ("cuda" by default;
  "cpu" runs the kernels' plain PyTorch versions).  ``kernel_variant``
  picks the vote kernel: "lanes" (default) packs the lane layout in C++
  and counts with the lanes vote kernel plus the overflow vote kernel
  over the cap-overflow list (``LanesPolisher``), fetching compact uint8
  results; "mxu" packs the uint8 chunk layout in C++ and counts the
  whole pileup with the chunk vote kernel (``PolisherModel``).
- ``xla``: the chunk layout of "mxu" counted by a torch scatter-add on
  ``device`` (``PolisherModel(use_kernel=False)``; no hand kernel, as
  the JAX package leaves it to XLA).
- ``host``: the C++ fold of the (8, P) counts plus the C++ consensus —
  an independent reference for the device paths, never a fallback.
- ``sharded``: votes and consensus over a (data, pos) grid of devices
  (``mesh``, parallel/shard.py): variant "lanes" packs one uncapped lane
  pack per grid cell in C++ (``ParsedRuns.lanes_mesh``) and counts each
  with the lanes vote kernel on the cell's device; "mxu" scatter-adds
  each cell's events; the counts sum over the data axis and the
  consensus runs per position shard.  Never windowed.

``kernel_variant`` None takes POLYPOLISH_TPU_KERNEL ("lanes" or "mxu";
unset or anything else reads "lanes"), as the JAX package does.

The pure-Python reader fills each contig's event stream (``ops/pack.py``)
instead of the native runs; its backends are the JAX package's event
branches: ``host`` counts with numpy, ``device`` packs the events into
chunks (``PolisherModel.pack``) and counts the whole pileup with the
chunk vote kernel, whatever ``kernel_variant`` says, ``xla`` counts
with a torch scatter-add, and ``sharded`` routes the events to the grid
(the numpy mesh packer and the lanes vote kernel per cell, or a scatter
per cell for "mxu").  Depth and thresholds stay on the host.

Contigs of POLYPOLISH_TPU_WINDOW_MIN positions or more (32,000,000 by
default; 0 disables) take the windowed path on backends ``host`` and
``device`` (variant lanes) unless --debug is on: position windows of
POLYPOLISH_TPU_WINDOW (8,000,000) keep the host buffers O(window)
instead of O(P), one window after another.

All are byte-identical to polypolish_tpu (run with the same backend and
POLYPOLISH_TPU_KERNEL) for the FASTA, the --debug TSV and the stderr
narrative.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np
import torch

from polypolish_tpu_torch import __version__, log
from polypolish_tpu_torch.errors import check_if_file_exists, quit_with_error
from polypolish_tpu_torch.io.fasta import load_fasta, write_fasta_record
from polypolish_tpu_torch.native import binding
from polypolish_tpu_torch.native import runs as native_runs
from polypolish_tpu_torch.ops import pack
from polypolish_tpu_torch.ops.consensus import (
    ST_CHANGED,
    STATUS_STRINGS,
    compute_thresholds,
    consensus_dense_core,
    consensus_dense_numpy,
    consensus_sparse_override,
)
from polypolish_tpu_torch.ops.vote import count_votes
from polypolish_tpu_torch.ops.vote_lanes import R_SUB, TILE_W, geom_pad
from polypolish_tpu_torch.stats import qscore
from polypolish_tpu_torch.utils.profiling import StageTimer, maybe_trace, phase
from polypolish_tpu_torch.utils.timing import format_duration
from polypolish_tpu_torch.vocab import DENSE_V, Vocab

BACKENDS = ("device", "host", "xla", "sharded")
KERNEL_VARIANTS = ("lanes", "mxu")


def fmt_f64(x: float) -> str:
    """Rust's f64 Display: integral values print without a trailing .0."""
    if x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def resolve_device(device) -> torch.device:
    """The torch device the caller asked for; raises when it asks for
    CUDA and there is none (the port never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def polish(
    debug: Optional[str],
    fraction_invalid: float,
    fraction_valid: float,
    max_errors: int,
    min_depth: int,
    careful: bool,
    assembly: str,
    sam: List[str],
    out: Optional[TextIO] = None,
    backend: str = "device",
    n_threads: Optional[int] = None,
    device="cuda",
    timer: Optional[StageTimer] = None,
    kernel_variant: Optional[str] = None,
    use_native: bool = True,
    mesh=None,
) -> List[Tuple[str, int]]:
    """Run the full polish workflow; returns [(name, new_length)].

    ``kernel_variant`` ("lanes" or "mxu"; None reads
    POLYPOLISH_TPU_KERNEL) picks the vote kernel of backend "device" on
    the native path and the step of backend "sharded".  ``mesh`` is the
    (data, pos) grid of backend "sharded" (parallel.make_mesh); None
    spans ``device``'s visible devices: every visible card for "cuda",
    one cell for "cpu".  ``use_native=False`` reads the SAM files with
    the pure-Python reader (``--pure-python``).
    ``timer`` (optional) collects wall seconds per stage: parse, fold,
    pack, upload, kernel_a, kernel_b, scatter, data_sum (backend
    sharded), consensus, fetch, finish."""
    start_time = time.monotonic()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got "
                         f"{backend!r}")
    if kernel_variant is None:
        kernel_variant = kernel_variant_env()
    if kernel_variant not in KERNEL_VARIANTS:
        raise ValueError(f"kernel_variant must be one of "
                         f"{KERNEL_VARIANTS}; got {kernel_variant!r}")
    # the host backend runs no torch code, so it needs no device
    dev = resolve_device(device) if backend != "host" else None
    if backend == "sharded" and mesh is None:
        from polypolish_tpu_torch.parallel.multihost import global_mesh

        mesh = global_mesh(device=dev)
    if timer is None:
        timer = StageTimer()
    if out is None:
        out = sys.stdout
    check_option_values(fraction_invalid, fraction_valid)
    check_inputs_exist(assembly, sam)
    starting_message(
        debug, fraction_invalid, fraction_valid, max_errors, min_depth,
        careful, assembly, sam,
    )
    with phase("load_assembly"):
        seq_names, votes = load_assembly(assembly)
    vocab = Vocab()
    runs_handle = None
    with phase("load_alignments"), timer.stage("parse"):
        if use_native:
            runs_handle = _load_alignments_runs(
                max_errors, careful, sam, votes, vocab, n_threads
            )
        else:
            load_alignments(max_errors, careful, sam, votes, vocab)
    try:
        with phase("polish_sequences"), maybe_trace():
            new_lengths = polish_sequences(
                debug, fraction_invalid, fraction_valid, min_depth,
                seq_names, votes, vocab, out, backend, runs_handle, dev,
                timer, kernel_variant, mesh,
            )
    finally:
        if runs_handle is not None:
            runs_handle.close()
    finished_message(debug, new_lengths, start_time)
    return new_lengths


def kernel_variant_env() -> str:
    """The vote-kernel variant of the JAX package's kernel_variant():
    POLYPOLISH_TPU_KERNEL when it is "lanes" or "mxu", else "lanes"."""
    v = os.environ.get("POLYPOLISH_TPU_KERNEL", "lanes")
    return v if v in KERNEL_VARIANTS else "lanes"


def check_option_values(fraction_invalid: float, fraction_valid: float) -> None:
    """Reference: polish.rs:277-287."""
    if fraction_valid <= 0.0 or fraction_valid >= 1.0:
        quit_with_error("--fraction_valid must be between 0 and 1 (exclusive)")
    if fraction_invalid <= 0.0 or fraction_invalid >= 1.0:
        quit_with_error("--fraction_invalid must be between 0 and 1 (exclusive)")
    if fraction_invalid >= fraction_valid:
        quit_with_error("--fraction_invalid must be less than --fraction_valid")


def check_inputs_exist(assembly: str, sam: List[str]) -> None:
    check_if_file_exists(assembly)
    for s in sam:
        check_if_file_exists(s)


def starting_message(
    debug, fraction_invalid, fraction_valid, max_errors, min_depth,
    careful, assembly, sam,
) -> None:
    log.section_header("Starting Polypolish-TPU polish")
    log.explanation(
        "Polypolish is a tool for polishing genome assemblies with short "
        "reads. Unlike other tools in this category, Polypolish uses SAM "
        "files where each read has been aligned to all possible locations "
        "(not just a single best location). This allows it to repair errors "
        "in repeat regions that other alignment-based polishers cannot fix."
    )
    log.eprint(f"Polypolish-TPU version: v{__version__}")
    log.eprint()
    log.eprint("Input assembly:")
    log.eprint(f"  {assembly}")
    log.eprint()
    log.eprint("Input short-read alignments:")
    for s in sam:
        log.eprint(f"  {s}")
    log.eprint()
    log.eprint("Settings:")
    log.eprint(f"  --fraction_invalid {fmt_f64(fraction_invalid)}")
    log.eprint(f"  --fraction_valid {fmt_f64(fraction_valid)}")
    log.eprint(f"  --max_errors {max_errors}")
    log.eprint(f"  --min_depth {min_depth}")
    if careful:
        log.eprint("  --careful")
    if debug is not None:
        log.eprint(f"  --debug {debug}")
    else:
        log.eprint("  not logging debugging information")
    log.eprint()


def finished_message(debug, new_lengths, start_time: float) -> None:
    log.section_header("Finished!")
    log.eprint("Polished sequence (to stdout):")
    for new_name, new_length in new_lengths:
        log.eprint(f"  {new_name}_polypolish ({log.thousands(new_length)} bp)")
    log.eprint()
    if debug is not None:
        log.eprint(f"Per-base debugging info written to {debug}")
    log.eprint(f"Time to run: {format_duration(time.monotonic() - start_time)}")
    log.eprint()


def load_assembly(assembly_filename: str):
    """Reference: polish.rs:93-106."""
    log.section_header("Loading assembly")
    fasta = load_fasta(assembly_filename)
    seq_names = []
    for name, description, sequence in fasta:
        log.eprint(f"{name} ({log.thousands(len(sequence))} bp)")
        seq_names.append((name, description))
    log.eprint()
    votes = pack.new_votes_from_fasta(fasta)
    return seq_names, votes


def _report_alignment_stats(sam, stats_list, careful: bool) -> None:
    """The per-file + kept/discarded stderr narrative (polish.rs:109-134).
    stats_list entries are (alignment_count, used_count, read_count)."""
    alignment_total = 0
    used_total = 0
    for s, (alignment_count, used_count, read_count) in zip(sam, stats_list):
        log.eprint(
            f"{s}: {log.thousands(alignment_count)} alignments from "
            f"{log.thousands(read_count)} reads"
        )
        alignment_total += alignment_count
        used_total += used_count
    discarded_count = alignment_total - used_total
    log.eprint()
    if careful:
        log.eprint(
            "Filtering for high-quality end-to-end alignments from reads "
            "with only one alignment:"
        )
    else:
        log.eprint("Filtering for high-quality end-to-end alignments:")
    log.eprint(f"  {log.thousands(used_total)} alignments kept")
    log.eprint(f"  {log.thousands(discarded_count)} alignments discarded")
    log.eprint()


def _load_alignments_runs(
    max_errors: int,
    careful: bool,
    sam: List[str],
    votes: Dict[str, pack.ContigVotes],
    vocab: Vocab,
    n_threads: Optional[int],
) -> native_runs.ParsedRuns:
    """One native pp_parse_runs call covering ALL SAM files (byte-range
    parallel per file, files in reference order; plain, gzipped and BAM
    input).  Reference: polish.rs:109-134."""
    log.section_header("Loading alignments")
    contig_names = list(votes.keys())
    contig_lens = {n: votes[n].length for n in contig_names}
    pr = native_runs.parse_runs(
        [str(s) for s in sam], contig_names, contig_lens, vocab,
        max_errors, careful, n_threads,
    )
    if n_threads == 1:  # batch mode: no per-genome fold threads
        pr.fold_parallel = False
    _report_alignment_stats(sam, pr.file_stats, careful)
    return pr


def load_alignments(
    max_errors: int,
    careful: bool,
    sam: List[str],
    votes: Dict[str, pack.ContigVotes],
    vocab: Vocab,
) -> None:
    """The pure-Python reader: each SAM file (plain, gzipped or BAM) in
    turn into the contigs' event streams (pack.process_sam).  Reference:
    polish.rs:109-134."""
    log.section_header("Loading alignments")
    stats_list = [pack.process_sam(s, votes, vocab, max_errors, careful)
                  for s in sam]
    _report_alignment_stats(sam, stats_list, careful)


def polish_sequences(
    debug, fraction_invalid, fraction_valid, min_depth,
    seq_names, votes, vocab, out: TextIO, backend: str,
    runs_handle, device: torch.device, timer: StageTimer, variant: str,
    mesh=None,
) -> List[Tuple[str, int]]:
    """Reference: polish.rs:137-154.  ``runs_handle`` None takes each
    contig's event stream (``contig.finalize()``) instead of the native
    runs; ``mesh`` is backend sharded's grid."""
    log.section_header("Polishing assembly sequences")
    log.explanation(
        "For each position in the assembly, Polypolish determines the read "
        "depth at that position and collects all aligned bases. It then "
        "polishes the assembly by looking for positions where the pileup "
        "unambiguously supports a different sequence than the assembly."
    )
    debug_file = _create_debug_file(debug)
    new_lengths = []
    try:
        for name, description in seq_names:
            contig = votes[name]
            new_length = polish_one_sequence(
                fraction_invalid, fraction_valid, min_depth,
                name, description, contig, vocab, out, backend, debug_file,
                runs_handle, device, timer, variant, mesh,
            )
            new_lengths.append((name, new_length))
    finally:
        if debug_file is not None:
            debug_file.close()
    return new_lengths


def _create_debug_file(debug):
    if debug is None:
        return None
    try:
        f = open(debug, "wt")
    except OSError:
        quit_with_error(f'unable to create "{debug}"')
    f.write("name\tpos\tbase\tdepth\tinvalid\tvalid\tpileup\tstatus\tnew_base\n")
    return f


def _orig_ids_for_seq(seq: str, vocab: Vocab) -> np.ndarray:
    """Vocab id of each original assembly character."""
    arr = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    table = np.full(256, -1, dtype=np.int32)
    for ch, vid in (("-", 0), ("A", 1), ("C", 2), ("G", 3), ("T", 4), ("N", 5)):
        table[ord(ch)] = vid
    ids = table[arr]
    missing = np.nonzero(ids < 0)[0]
    for i in missing:  # rare: IUPAC/odd chars in the assembly
        ids[i] = vocab.intern(seq[i])
    return ids


def polish_one_sequence(
    fraction_invalid, fraction_valid, min_depth,
    name, description, contig, vocab, out: TextIO, backend: str, debug_file,
    runs_handle, device: torch.device, timer: StageTimer, variant: str,
    mesh=None,
) -> int:
    """Reference: polish.rs:157-193 (vectorised).  ``variant`` is
    backend device's vote kernel on the native runs and backend
    sharded's step: "lanes" or "mxu"."""
    seq_len = contig.length
    log.eprint(f"Polishing {name} ({log.thousands(seq_len)} bp):")

    orig_id = _orig_ids_for_seq(contig.seq, vocab)
    thresholds = (min_depth, fraction_valid, fraction_invalid)
    # huge contigs stream through position windows (O(window) host
    # buffers), under the JAX package's conditions; --debug needs the
    # whole contig's counts
    windowed = (runs_handle is not None and debug_file is None
                and seq_len >= _window_min()
                and runs_handle.base_vocab_len <= DENSE_V)
    if windowed and backend == "host":
        return _polish_host_runs_windowed(
            runs_handle, name, description, contig.seq, orig_id, vocab,
            out, thresholds, timer,
        )
    if windowed and backend == "device" and variant == "lanes":
        return _polish_device_runs_windowed(
            runs_handle, name, description, contig.seq, orig_id, vocab,
            out, thresholds, device, timer,
        )
    if runs_handle is None and backend == "host":
        pos, vid, weight = contig.finalize()
        with timer.stage("fold"):
            counts, depth, sparse = count_votes(pos, vid, weight, seq_len,
                                                "host")
            valid_thr, invalid_thr, low_depth = compute_thresholds(
                depth, min_depth, fraction_valid, fraction_invalid
            )
        with timer.stage("consensus"):
            new_id, status = consensus_dense_numpy(
                counts, valid_thr, invalid_thr, low_depth, orig_id
            )
    elif runs_handle is None:
        pos, vid, weight = contig.finalize()
        (counts, new_id, status, depth, sparse,
         valid_thr, invalid_thr) = _polish_device(
            pos, vid, weight, seq_len, orig_id, thresholds, device, timer,
            backend, variant, mesh,
        )
    elif backend == "host":
        with timer.stage("fold"):
            counts, depth, sparse, thr = runs_handle.fold(
                name, thresholds=thresholds
            )
            valid_thr, invalid_thr, low_depth = thr
        with timer.stage("consensus"):
            new_id, status = binding.consensus_dense_native(
                counts, valid_thr, invalid_thr, low_depth, orig_id
            )
    else:
        (counts, new_id, status, depth, sparse,
         valid_thr, invalid_thr) = _polish_device_runs(
            runs_handle, name, seq_len, orig_id, thresholds, device, timer,
            backend, variant, mesh,
        )

    with timer.stage("finish"):
        return finish_sequence(
            name, description, contig.seq, counts, depth, sparse,
            valid_thr, invalid_thr, new_id, status, orig_id, min_depth,
            vocab, out, debug_file,
        )


def finish_sequence(
    name, description, seq, counts, depth, sparse,
    valid_thr, invalid_thr, new_id, status, orig_id, min_depth,
    vocab, out: TextIO, debug_file,
) -> int:
    """The backend-independent tail of polish_one_sequence: sparse-tier
    consensus override, --debug TSV, polished FASTA write, per-contig
    stats (reference: polish.rs:170-227).  ``counts`` is the host's
    (8, P) numpy array or the device's (8, P) tensor; from a tensor
    only the sparse positions' columns are fetched, unless --debug
    needs all of it."""
    sp_pos, sp_vid, sp_cnt = sparse
    if sp_pos.size:
        if isinstance(counts, torch.Tensor):
            upos = torch.from_numpy(np.unique(sp_pos)).to(counts.device)
            cols = counts[:, upos].cpu().numpy()
        else:
            cols = counts
        consensus_sparse_override(
            cols, sp_pos, sp_vid, sp_cnt, valid_thr, invalid_thr,
            depth, min_depth, orig_id, new_id, status,
            pregathered=isinstance(counts, torch.Tensor),
        )

    # the per-position dict is only needed for the --debug pileup column
    sparse_by_pos: Dict[int, List[Tuple[int, int]]] = {}
    if debug_file is not None and sp_pos.size:
        for p, v, c in zip(sp_pos.tolist(), sp_vid.tolist(),
                           sp_cnt.tolist()):
            sparse_by_pos.setdefault(p, []).append((v, c))

    if debug_file is not None:
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        _write_debug_lines(
            debug_file, name, seq, depth, invalid_thr, valid_thr,
            np.asarray(counts), sparse_by_pos, status, new_id, vocab,
        )

    polished_seq = _apply_edits(seq, status, new_id, vocab)
    write_fasta_record(out, name, description, polished_seq)

    # Sequential left-fold, not np.sum (pairwise): the reference adds
    # per-base depths one at a time in position order (polish.rs:177) and
    # f64 addition is order-sensitive.  The native helper is a strict
    # sequential scan.
    total_depth = binding.sum_f64_seq(depth) if len(depth) else 0.0
    zero_depth_count = int(np.count_nonzero(depth == 0.0))
    changed_count = int(np.count_nonzero(status == ST_CHANGED))
    print_polishing_info(
        len(seq), total_depth, zero_depth_count, changed_count
    )
    return len(polished_seq)


def _window_min() -> int:
    """Contig length from which the windowed paths run
    (POLYPOLISH_TPU_WINDOW_MIN; 0 disables windowing)."""
    try:
        v = int(os.environ.get("POLYPOLISH_TPU_WINDOW_MIN", 32_000_000))
    except ValueError:
        v = 32_000_000
    return v if v > 0 else (1 << 62)


def _window_size() -> int:
    """Window width (POLYPOLISH_TPU_WINDOW, default 8,000,000).  An
    explicit value may be arbitrarily small (tests use tiny windows on
    short genomes to cross many window boundaries)."""
    raw = os.environ.get("POLYPOLISH_TPU_WINDOW")
    if raw is not None:
        try:
            v = int(raw)
            if v > 0:
                return v
        except ValueError:
            pass
    return 8_000_000


class _WindowTally:
    """What the windowed paths keep of a contig across windows: the edit
    list and the stats.  The depth total is one strict f64 left-fold
    over all windows in position order (polish.rs:177), carried from
    window to window, never a sum of per-window sums."""

    def __init__(self) -> None:
        self.changed_pos: List[np.ndarray] = []
        self.changed_vid: List[np.ndarray] = []
        self.total_depth = 0.0
        self.zero_depth_count = 0
        self.changed_count = 0

    def add(self, w_lo: int, status, new_id, depth) -> None:
        ch = np.nonzero(status == ST_CHANGED)[0]
        if ch.size:
            self.changed_pos.append((ch + w_lo).astype(np.int64))
            self.changed_vid.append(new_id[ch].copy())
            self.changed_count += int(ch.size)
        self.total_depth = binding.sum_f64_seq_init(depth, self.total_depth)
        self.zero_depth_count += int(np.count_nonzero(depth == 0.0))

    def write(self, name, description, seq, vocab, out) -> int:
        """Splice the edits, write the FASTA record and the contig's
        stats; returns the polished length."""
        cp = (np.concatenate(self.changed_pos) if self.changed_pos
              else np.empty(0, np.int64))
        cv = (np.concatenate(self.changed_vid) if self.changed_vid
              else np.empty(0, np.int32))
        polished_seq = _apply_edits_sparse(seq, cp, cv, vocab)
        write_fasta_record(out, name, description, polished_seq)
        print_polishing_info(len(seq), self.total_depth,
                             self.zero_depth_count, self.changed_count)
        return len(polished_seq)


def _polish_host_runs_windowed(
    runs_handle, name, description, seq, orig_id, vocab, out, thresholds,
    timer,
) -> int:
    """The host backend for huge contigs: C++ fold and consensus in
    position windows of O(W) memory (pp_fold_window), with the sparse
    tier overridden inside the window whose full counts are at hand
    (pregathered=False).  Counterpart of the JAX package's
    _polish_host_runs_windowed (polish.rs:157-227 at 100 Mb scale)."""
    seq_len = len(seq)
    sp_pos, sp_vid, sp_cnt = runs_handle.sparse(name)
    min_depth = thresholds[0]
    W = _window_size()
    tally = _WindowTally()
    for w_lo in range(0, seq_len, W):
        w_hi = min(seq_len, w_lo + W)
        with timer.stage("fold"):
            counts_w, depth_w, (valid_w, invalid_w, low_w) = \
                runs_handle.fold_window(name, w_lo, w_hi, thresholds)
        with timer.stage("consensus"):
            orig_w = orig_id[w_lo:w_hi]
            new_id_w, status_w = binding.consensus_dense_native(
                counts_w, valid_w, invalid_w, low_w, orig_w
            )
            i0, i1 = np.searchsorted(sp_pos, [w_lo, w_hi])
            if i1 > i0:
                consensus_sparse_override(
                    counts_w, sp_pos[i0:i1] - w_lo, sp_vid[i0:i1],
                    sp_cnt[i0:i1], valid_w, invalid_w, depth_w, min_depth,
                    orig_w, new_id_w, status_w,
                )
        with timer.stage("finish"):
            tally.add(w_lo, status_w, new_id_w, depth_w)
    with timer.stage("finish"):
        return tally.write(name, description, seq, vocab, out)


def _polish_device_runs_windowed(
    runs_handle, name, description, seq, orig_id, vocab, out, thresholds,
    device, timer,
) -> int:
    """The device backend (variant lanes) for huge contigs: depth and
    thresholds from pp_fold_window (no host counts), votes from kernel
    A on each window's native packed4 pack (pp_lanes_from_runs with
    window origin w_lo) plus the overflow vote kernel over the window's
    cap-overflow list, consensus on ``device``, decisions fetched as
    uint8.  Every window has the same padded width w_pad, a multiple of
    TILE_W.

    Windows run one after another, in position order, so the depth
    total is one left-fold.  The JAX package's
    POLYPOLISH_TPU_WINDOW_DEPTH (windows in flight) is accepted and
    changes nothing here: a window's card work is about a millisecond
    against tenths of a second of host fold and pack, so there is
    nothing for a queue of windows to overlap.  Only the (8, n_unique)
    columns at the window's sparse positions are fetched of its counts.
    Counterpart of the JAX package's _polish_device_runs_windowed;
    where that falls back (no pack), this raises."""
    from polypolish_tpu_torch.models.polisher import LanesPolisher

    seq_len = len(seq)
    sp_pos, sp_vid, sp_cnt = runs_handle.sparse(name)
    min_depth = thresholds[0]
    w_pad = -(-_window_size() // TILE_W) * TILE_W
    model = LanesPolisher(w_pad, device, R_SUB, TILE_W, timer=timer)
    i32max = np.int32(2**31 - 1)

    def pad_w(arr, fill, dtype):
        # positions past the contig's end: low_depth, thresholds
        # INT32_MAX, orig_id 0, and no events in the pack
        a = np.full(w_pad, fill, dtype=dtype)
        a[: arr.shape[0]] = arr
        return torch.from_numpy(a).to(device)

    tally = _WindowTally()
    for w_lo in range(0, seq_len, w_pad):
        w_hi = min(seq_len, w_lo + w_pad)
        w_real = w_hi - w_lo
        with timer.stage("fold"):
            _, depth_w, (valid_w, invalid_w, low_w) = \
                runs_handle.fold_window(name, w_lo, w_hi, thresholds,
                                        want_counts=False)
        with timer.stage("pack"):
            pack = runs_handle.lanes(
                name, model.r_sub, model.tile_w, num_positions=w_pad,
                packed4=True, cap=True, w_lo=w_lo,
            )
        if pack is None:
            raise RuntimeError(
                f"the native lane packer returned no pack for {name} "
                f"window [{w_lo}, {w_hi}) ({w_pad} positions): bad "
                f"arguments or out of memory"
            )
        i0, i1 = np.searchsorted(sp_pos, [w_lo, w_hi])
        try:
            with timer.stage("upload"):
                thr_args = (
                    pad_w(valid_w, i32max, np.int32),
                    pad_w(invalid_w, i32max, np.int32),
                    pad_w(low_w, True, bool),
                    pad_w(orig_id[w_lo:w_hi], 0, np.int32),
                )
            counts_t, adopted_u8, status_u8 = model.forward_pack(
                pack.vb, pack.block_tile, *thr_args,
                ov_pos=pack.ov_pos, ov_vid=pack.ov_vid,
            )
            # the fetch waits for the device, so the pack outlives every
            # read of it
            with timer.stage("fetch"):
                status = status_u8[:w_real].cpu().numpy().astype(np.int32)
                adopted = adopted_u8[:w_real].cpu().numpy().astype(np.int32)
                cols = None
                if i1 > i0:
                    upos = np.unique(sp_pos[i0:i1] - w_lo)
                    cols = counts_t[:, torch.from_numpy(upos).to(device)]
                    cols = cols.cpu().numpy()
        finally:
            pack.close()
        del counts_t, adopted_u8, status_u8
        with timer.stage("finish"):
            orig_w = orig_id[w_lo:w_hi]
            # CHANGED adopts the dense id; every keep status keeps the
            # (possibly sparse) original id
            new_id_w = np.where(status == ST_CHANGED, adopted,
                                orig_w).astype(np.int32)
            if i1 > i0:
                consensus_sparse_override(
                    cols, sp_pos[i0:i1] - w_lo, sp_vid[i0:i1],
                    sp_cnt[i0:i1], valid_w, invalid_w, depth_w, min_depth,
                    orig_w, new_id_w, status, pregathered=True,
                )
            tally.add(w_lo, status, new_id_w, depth_w)
    with timer.stage("finish"):
        return tally.write(name, description, seq, vocab, out)


def _pad_bucket(n: int, granularity_bits: int = 3, minimum: int = 4096) -> int:
    """Round n up to a geometric bucket (<= 12.5% padding) — the JAX
    package's position bucket, kept so both pad the position axis, and
    therefore the lane pack, identically."""
    return geom_pad(n, bits=granularity_bits, minimum=minimum)


def _polish_sharded_lanes(runs_handle, mesh, name, seq_len, thr, orig_id,
                          timer):
    """Backend sharded, variant lanes, on the native runs: one C++ call
    packs every grid cell's lane blocks (``lanes_mesh``, packed4, over
    the geometric position bucket), then kernel A per cell, the
    data-axis sum and the consensus per position shard
    (``sharded_step_lanes``).  Returns (counts (8, seq_len) tensor,
    new_id, status).  The JAX package's _polish_sharded_lanes; where it
    falls back to the scatter step (no pack), this raises."""
    from polypolish_tpu_torch.parallel.shard import sharded_step_lanes

    n_data, n_pos = mesh.shape
    p_pad = _pad_bucket(seq_len)
    with timer.stage("pack"):
        packed = runs_handle.lanes_mesh(
            name, n_data, n_pos, R_SUB, TILE_W,
            n_threads=binding.default_threads(), num_positions=p_pad,
            packed4=True,
        )
    if packed is None:
        raise RuntimeError(
            f"the native mesh packer returned no pack for {name} "
            f"({p_pad} positions, {n_data}x{n_pos} grid): bad arguments "
            f"or out of memory"
        )
    vb, bt, p_shard, n_tiles = packed
    counts, new_id, status = sharded_step_lanes(
        mesh, vb, bt, p_shard, n_tiles, *thr, orig_id, timer=timer,
    )
    return counts[:, :seq_len], new_id[:seq_len], status[:seq_len]


def _polish_device_runs(
    runs_handle, name, seq_len, orig_id, thresholds, device, timer,
    backend, variant, mesh=None,
):
    """Device paths fed by the native run pipeline: depth and thresholds
    folded in C++ (sequential-exact f64), sparse tier from the overflow
    list, votes and consensus on ``device``: from the native packed4
    lane pack (backend device, variant lanes: the lanes branch of the
    JAX package's _polish_device_runs), or from the native uint8 chunk
    layout through ``PolisherModel`` (variant mxu on the chunk vote
    kernel; backend xla on a torch scatter-add), or over ``mesh``
    (backend sharded: the mesh pack and kernel A per cell for variant
    lanes, each cell's events scatter-added for mxu).  Returns (counts
    (8, seq_len) tensor or numpy array, new_id, status, depth, sparse,
    valid_thr, invalid_thr)."""
    from polypolish_tpu_torch.models.polisher import LanesPolisher

    with timer.stage("fold"):
        _, depth, _, thr = runs_handle.fold(
            name, want_counts=False, thresholds=thresholds,
        )
        valid_thr, invalid_thr, low_depth = thr
        sparse = runs_handle.sparse(name)

    if backend == "sharded":
        if variant == "lanes":
            counts, new_id, status = _polish_sharded_lanes(
                runs_handle, mesh, name, seq_len, thr, orig_id, timer)
        else:
            from polypolish_tpu_torch.parallel.shard import (
                sharded_vote_consensus,
            )

            with timer.stage("pack"):
                pos, vid, _w = runs_handle.events(name)
            counts, new_id, status = sharded_vote_consensus(
                mesh, pos, vid, seq_len, *thr, orig_id, timer=timer)
        return counts, new_id, status, depth, sparse, valid_thr, invalid_thr

    p_pad = _pad_bucket(seq_len)
    i32max = np.int32(2**31 - 1)

    def pad(arr, fill, dtype):
        out = np.full(p_pad, fill, dtype=dtype)
        out[:seq_len] = arr
        return torch.from_numpy(out).to(device)

    with timer.stage("upload"):
        thr_args = (
            pad(valid_thr, i32max, np.int32),
            pad(invalid_thr, i32max, np.int32),
            pad(low_depth, True, bool),
            pad(orig_id, 0, np.int32),
        )
    if backend == "xla" or variant == "mxu":
        counts, new_id, status = _vote_chunks_runs(
            runs_handle, name, seq_len, p_pad, thr_args, device, timer,
            use_kernel=backend == "device",
        )
        return counts, new_id, status, depth, sparse, valid_thr, invalid_thr

    model = LanesPolisher(p_pad, device, R_SUB, TILE_W, timer=timer)
    with timer.stage("pack"):
        lanes = runs_handle.lanes(
            name, model.r_sub, model.tile_w, num_positions=p_pad,
            packed4=True, cap=True,
        )
    if lanes is None:
        raise RuntimeError(
            f"the native lane packer returned no pack for {name} "
            f"({p_pad} positions): bad arguments or out of memory"
        )
    try:
        counts_t, adopted_u8, status_u8 = model.forward_pack(
            lanes.vb, lanes.block_tile, *thr_args,
            ov_pos=lanes.ov_pos, ov_vid=lanes.ov_vid,
        )
        # compact uint8 fetch; new_id rebuilt host-side: CHANGED adopts
        # the dense id, every keep status keeps the (possibly sparse)
        # original id.  The fetch also waits for the device, so the
        # pack outlives every read of it.
        with timer.stage("fetch"):
            status = status_u8[:seq_len].cpu().numpy().astype(np.int32)
            adopted = adopted_u8[:seq_len].cpu().numpy().astype(np.int32)
    finally:
        lanes.close()
    new_id = np.where(status == ST_CHANGED, adopted, orig_id)
    new_id = new_id.astype(np.int32)
    counts = counts_t[:, :seq_len]
    return counts, new_id, status, depth, sparse, valid_thr, invalid_thr


def _vote_chunks_runs(runs_handle, name, seq_len, p_pad, thr_args, device,
                      timer, use_kernel):
    """Votes and consensus of one contig through ``PolisherModel`` over
    the native uint8 chunk layout (pad vocab 255, 2 B/event), or over
    the int16/int8 chunks of ``PolisherModel.pack`` where the native
    layout has none (tile_p > 256).  Returns (counts (8, seq_len)
    tensor, new_id, status) — the non-lanes tail of the JAX package's
    _polish_device_runs."""
    from polypolish_tpu_torch.models.polisher import PolisherModel
    from polypolish_tpu_torch.ops.vote_chunks import E_SUB, TILE_P

    model = PolisherModel(p_pad, device, use_kernel=use_kernel, timer=timer)
    with timer.stage("pack"):
        ch = runs_handle.chunks(name, TILE_P, E_SUB, num_positions=p_pad)
    with timer.stage("upload"):
        if ch is None:
            pos, vid, _w = runs_handle.events(name)
            chunks = model.pack(pos, vid)
        else:
            chunks = [torch.from_numpy(a).to(device) for a in ch[:3]]
    counts_t, new_id_t, status_t = model(*chunks, *thr_args)
    with timer.stage("fetch"):
        new_id = new_id_t[:seq_len].cpu().numpy()
        status = status_t[:seq_len].cpu().numpy()
    return counts_t[:, :seq_len], new_id, status


def _polish_device(pos, vid, weight, seq_len, orig_id, thresholds, device,
                   timer, backend, variant="lanes", mesh=None):
    """The device backends of the event stream (the JAX package's
    _polish_device): f64 depth, sparse tier and thresholds on the host
    (numpy), then the dense votes and the consensus on ``device`` over a
    geometric position bucket (pad positions: low_depth, thresholds
    INT32_MAX, orig_id 0, so they keep).  Backend "device" packs the
    events into chunks (``PolisherModel.pack``) and counts them with the
    chunk vote kernel; "xla" counts with a torch scatter-add; "sharded"
    votes over ``mesh``: the numpy mesh pack and kernel A per cell
    (variant lanes) or a scatter per cell (mxu).  Returns (counts
    (8, seq_len) tensor or numpy array, new_id, status, depth, sparse,
    valid_thr, invalid_thr)."""
    from polypolish_tpu_torch.models.polisher import PolisherModel
    from polypolish_tpu_torch.ops.vote import (
        dense_counts_xla,
        depth_host,
        sparse_counts_host,
    )

    min_depth, fraction_valid, fraction_invalid = thresholds
    with timer.stage("fold"):
        depth = depth_host(pos, weight, seq_len)
        sparse = sparse_counts_host(pos, vid)
        valid_thr, invalid_thr, low_depth = compute_thresholds(
            depth, min_depth, fraction_valid, fraction_invalid
        )
    if backend == "sharded":
        from polypolish_tpu_torch.parallel import shard

        step = (shard.sharded_vote_consensus_lanes if variant == "lanes"
                else shard.sharded_vote_consensus)
        counts, new_id, status = step(
            mesh, pos, vid, seq_len, valid_thr, invalid_thr, low_depth,
            orig_id, timer=timer)
        return counts, new_id, status, depth, sparse, valid_thr, invalid_thr
    p_pad = _pad_bucket(seq_len)
    i32max = np.int32(2**31 - 1)

    def pad(arr, fill, dtype):
        out = np.full(p_pad, fill, dtype=dtype)
        out[:seq_len] = arr
        return torch.from_numpy(out).to(device)

    with timer.stage("upload"):
        thr_args = (
            pad(valid_thr, i32max, np.int32),
            pad(invalid_thr, i32max, np.int32),
            pad(low_depth, True, bool),
            pad(orig_id, 0, np.int32),
        )
    if backend == "device":
        model = PolisherModel(p_pad, device, timer=timer)
        with timer.stage("pack"):
            chunks = model.pack(pos, vid)
        counts_t, new_id_t, status_t = model(*chunks, *thr_args)
    else:
        with timer.stage("upload"):
            d_pos = torch.from_numpy(np.asarray(pos, np.int64)).to(device)
            d_vid = torch.from_numpy(np.asarray(vid, np.int64)).to(device)
        with timer.stage("scatter"):
            counts_t = dense_counts_xla(d_pos, d_vid, p_pad)
        del d_pos, d_vid
        with timer.stage("consensus"):
            new_id_t, status_t = consensus_dense_core(counts_t, *thr_args)
    with timer.stage("fetch"):
        new_id = new_id_t[:seq_len].cpu().numpy()
        status = status_t[:seq_len].cpu().numpy()
    return (counts_t[:, :seq_len], new_id, status, depth, sparse,
            valid_thr, invalid_thr)


def _apply_edits(seq: str, status: np.ndarray, new_id: np.ndarray, vocab: Vocab) -> str:
    """Polished sequence = original with CHANGED positions spliced in.

    All keep statuses emit the original character; Changed positions emit
    the adopted vocab string ('-' id 0 -> deletion).  Equivalent to the
    reference's per-base string build + ``replace("-","")``
    (polish.rs:170-188) but O(changes) instead of O(len).
    """
    changed = np.nonzero(status == ST_CHANGED)[0]
    return _apply_edits_sparse(seq, changed, new_id[changed], vocab)


def _apply_edits_sparse(seq: str, changed_pos, changed_vid, vocab: Vocab) -> str:
    """_apply_edits from an explicit (positions, adopted ids) edit list."""
    if changed_pos.size == 0:
        # The reference strips "-" from the whole polished string
        # (polish.rs:188), which also removes literal '-' chars that were
        # present in the assembly itself.
        return seq.replace("-", "") if "-" in seq else seq
    parts: List[str] = []
    prev = 0
    for p, vid in zip(changed_pos.tolist(), changed_vid.tolist()):
        parts.append(seq[prev:p])
        if vid != 0:
            parts.append(vocab.string(int(vid)))
        prev = p + 1
    parts.append(seq[prev:])
    polished = "".join(parts)
    return polished.replace("-", "") if "-" in polished else polished


def pileup_count_str(counts_col, sparse_items, vocab: Vocab) -> str:
    """The debug "pileup" column: sorted comma-joined SEQxCOUNT entries
    (reference: pileup.rs:137-148)."""
    entries = []
    for v in range(DENSE_V):
        c = int(counts_col[v])
        if c > 0:
            entries.append(f"{vocab.string(v)}x{c}")
    for v, c in sparse_items:
        entries.append(f"{vocab.string(v)}x{c}")
    entries.sort()
    return ",".join(entries)


def _write_debug_lines_native(
    debug_file, name, seq, depth, invalid_thr, valid_thr, counts,
    sparse_by_pos, status, new_id, vocab,
) -> bool:
    """The C++ streaming TSV writer; False -> use the Python loop.

    Gated to ASCII content (non-ASCII vocab/sequence characters would be
    encoded utf-8 by the Python text stream but latin-1 by the native
    writer — never the case for real SAM/FASTA input, but the Python
    loop keeps even that path byte-consistent)."""
    if not (seq.isascii() and name.isascii()
            and all(s.isascii() for s in vocab.strings)):
        return False
    if sparse_by_pos:
        sp_pos_l: List[int] = []
        sp_vid_l: List[int] = []
        sp_cnt_l: List[int] = []
        for p in sorted(sparse_by_pos):
            for v, c in sparse_by_pos[p]:
                sp_pos_l.append(p)
                sp_vid_l.append(v)
                sp_cnt_l.append(c)
        sp = (np.asarray(sp_pos_l, dtype=np.int64),
              np.asarray(sp_vid_l, dtype=np.int32),
              np.asarray(sp_cnt_l, dtype=np.int32))
    else:
        sp = (np.empty(0, np.int64), np.empty(0, np.int32),
              np.empty(0, np.int32))
    binding.debug_tsv_native(
        debug_file, name, seq, depth, invalid_thr, valid_thr, counts,
        *sp, status, new_id, ST_CHANGED, vocab.strings, STATUS_STRINGS,
    )
    return True


def _write_debug_lines(
    debug_file, name, seq, depth, invalid_thr, valid_thr, counts,
    sparse_by_pos, status, new_id, vocab,
) -> None:
    """Per-base debug TSV (reference: polish.rs:230-266, pileup.rs:137-166).

    Columns: name pos base depth invalid valid pileup status new_base,
    with the pileup column as sorted comma-joined "SEQxCOUNT" entries.
    Uses the native (C++) streaming writer for ASCII content; the Python
    loop below is its byte-identical twin for the rest.
    """
    if _write_debug_lines_native(
        debug_file, name, seq, depth, invalid_thr, valid_thr, counts,
        sparse_by_pos, status, new_id, vocab,
    ):
        return
    for p in range(len(seq)):
        count_str = pileup_count_str(
            counts[:, p], sparse_by_pos.get(p, ()), vocab
        )
        st = int(status[p])
        nid = int(new_id[p])
        new_base = vocab.string(nid) if st == ST_CHANGED else seq[p]
        debug_file.write(
            f"{name}\t{p}\t{seq[p]}\t{depth[p]:.1f}\t{int(invalid_thr[p])}\t"
            f"{int(valid_thr[p])}\t{count_str}\t{STATUS_STRINGS[st]}\t"
            f"{new_base}\n"
        )


def print_polishing_info(
    seq_len: int, total_depth: float, zero_depth_count: int, changed_count: int
) -> None:
    """Reference: polish.rs:206-227."""
    seq_len_f = float(seq_len)
    mean_depth = total_depth / seq_len_f
    log.eprint(f"  mean read depth: {mean_depth:.1f}x")

    have = "has" if zero_depth_count == 1 else "have"
    covered = seq_len - zero_depth_count
    coverage = 100.0 * covered / seq_len_f
    log.eprint(
        f"  {log.thousands(zero_depth_count)} bp {have} a depth of zero "
        f"({coverage:.4f}% coverage)"
    )

    changed_percent = 100.0 * changed_count / seq_len_f
    estimated_accuracy = 100.0 - changed_percent
    estimated_qscore = qscore(estimated_accuracy)
    positions = "position" if changed_count == 1 else "positions"
    log.eprint(
        f"  {log.thousands(changed_count)} {positions} changed "
        f"({changed_percent:.4f}% of total positions)"
    )
    log.eprint(
        f"  estimated pre-polishing sequence accuracy: "
        f"{estimated_accuracy:.4f}% ({estimated_qscore})"
    )
    log.eprint()
