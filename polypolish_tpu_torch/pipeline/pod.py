"""Host-sharded polish of one genome, ``--pod-shards`` (counterpart of
polypolish_tpu/pipeline/pod.py; BASELINE config 4).

Every shard parses only its byte range of EVERY SAM file (read-group
snapped: the same boundary arithmetic in every shard makes the ranges
disjoint and complete, as the in-process thread split does in
sam_packer.cc), then the shards merge:

- dense counts: order-free integer sums over the shards' host folds,
- sparse tier: per-shard vocab ids remapped into the deterministically
  merged global vocab (shard order = file order), then summed,
- depth (order-sensitive f64): the 16-byte-per-alignment run headers
  are gathered in reference order (file-major, shard ranges ascending
  within each file) and replayed by pp_depth_fold, bit-identical to an
  unsharded run,

so the polished FASTA and --debug TSV are byte-identical to ``polish``.
Here the shards run one after another in one process; the multi-process
pod over ``torch.distributed`` uses the same merge.  This path folds on
the host and launches no kernel.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, TextIO, Tuple

import numpy as np

from polypolish_tpu_torch import log
from polypolish_tpu_torch.errors import quit_with_error
from polypolish_tpu_torch.ops.consensus import (
    compute_thresholds,
    consensus_dense_numpy,
)
from polypolish_tpu_torch.pipeline.polish import (
    _create_debug_file,
    _orig_ids_for_seq,
    _report_alignment_stats,
    check_inputs_exist,
    check_option_values,
    finish_sequence,
    finished_message,
    load_assembly,
    starting_message,
)
from polypolish_tpu_torch.vocab import DENSE_V, Vocab


def polish_pod(
    debug: Optional[str],
    fraction_invalid: float,
    fraction_valid: float,
    max_errors: int,
    min_depth: int,
    careful: bool,
    assembly: str,
    sam: List[str],
    n_procs: int,
    out: Optional[TextIO] = None,
    n_threads: Optional[int] = None,
) -> List[Tuple[str, int]]:
    """Polish with the SAM ingest sharded over ``n_procs`` byte-range
    shards, parsed one after another in this process.  Byte-identical
    to polish()."""
    start_time = time.monotonic()
    if out is None:
        out = sys.stdout
    seq_names, contigs, contig_names, contig_lens = start_pod(
        debug, fraction_invalid, fraction_valid, max_errors, min_depth,
        careful, assembly, sam,
    )
    shards, shard_vocabs = parse_pod_shards(
        sam, contig_names, contig_lens, max_errors, careful, n_procs,
        n_threads,
    )
    vocab, remaps = merge_vocabs(shard_vocabs)
    # the whole-file zero-alignment fatal was deferred by the shard
    # parses (a RANGE may be empty)
    report_file_stats(sam, [sh.file_stats for sh in shards], careful)
    log.eprint(
        f"Pod mode: SAM ingest sharded over {n_procs} byte-range shards"
    )
    log.eprint()

    headers = gather_headers([sh.raw()[:4] for sh in shards],
                             [sh.file_runs for sh in shards], len(sam))
    polishing_header()
    debug_file = _create_debug_file(debug)
    new_lengths = []
    try:
        for name, description in seq_names:
            log.eprint(f"Polishing {name} "
                       f"({log.thousands(contig_lens[name])} bp):")
            counts = np.zeros((DENSE_V, contig_lens[name]), dtype=np.int32)
            keys, cnts = [], []
            for sh, remap in zip(shards, remaps):
                c, _d, sparse = sh.fold(name)
                counts += c
                k, n = sparse_keys(sparse, sh.base_vocab_len, remap)
                keys.append(k)
                cnts.append(n)
            new_lengths.append((name, finish_contig(
                name, description, contigs[name].seq, counts,
                merge_sparse(keys, cnts), headers, contig_names.index(name),
                vocab, min_depth, fraction_valid, fraction_invalid, out,
                debug_file,
            )))
    finally:
        if debug_file is not None:
            debug_file.close()
        for sh in shards:
            sh.close()
    finished_message(debug, new_lengths, start_time)
    return new_lengths


def refuse_or_note(use_native: bool, backend: str) -> None:
    """The pod's ingest needs the native byte-range parser, and its
    votes and consensus run through the host fold: refuse
    --pure-python, and note a --backend other than host or auto."""
    if not use_native:
        quit_with_error(
            "--pod-shards requires the native engine and is "
            "incompatible with --pure-python"
        )
    if backend not in ("host", "auto"):
        print(
            f"note: --pod-shards uses the host fold; ignoring "
            f"--backend {backend}",
            file=sys.stderr,
        )


def parse_pod_shards(sam, contig_names, contig_lens, max_errors, careful,
                     n_procs, n_threads=None):
    """One ParsedRuns per shard, each with its own Vocab (a multi-process
    pod runs one of these per process)."""
    from polypolish_tpu_torch.native import runs as native_runs

    shards = []
    vocabs = []
    for i in range(n_procs):
        v = Vocab()
        shards.append(native_runs.parse_runs(
            [str(s) for s in sam], contig_names, contig_lens, v,
            max_errors, careful, n_threads, proc_idx=i, n_procs=n_procs,
        ))
        vocabs.append(v)
    return shards, vocabs


def merge_vocabs(shard_vocabs: List[Vocab]):
    """Deterministic global vocab: first occurrence in shard order
    (= file order, since shard ranges ascend within each file).
    Returns (global vocab, per-shard id remap arrays)."""
    vocab = Vocab()
    base = len(Vocab().strings)
    remaps = []
    for v in shard_vocabs:
        remap = np.asarray(
            [vocab.intern(s) for s in v.strings[base:]], dtype=np.int64
        )
        remaps.append(remap)
    return vocab, remaps


def start_pod(debug, fraction_invalid, fraction_valid, max_errors,
              min_depth, careful, assembly, sam):
    """Option and input checks, the starting narrative and the assembly,
    up to the "Loading alignments" header: (seq_names, contigs, contig
    names, {name: length})."""
    check_option_values(fraction_invalid, fraction_valid)
    check_inputs_exist(assembly, sam)
    starting_message(
        debug, fraction_invalid, fraction_valid, max_errors, min_depth,
        careful, assembly, sam,
    )
    seq_names, contigs = load_assembly(assembly)
    contig_lens = {n: c.length for n, c in contigs.items()}
    log.section_header("Loading alignments")
    return seq_names, contigs, list(contigs), contig_lens


def report_file_stats(sam, per_shard_stats, careful: bool) -> None:
    """Sum each file's (alignments, ...) stats over the shards, each an
    (n files, 3) sequence; quit on a file with no alignment at all,
    else report them."""
    total = np.zeros((len(sam), 3), dtype=np.int64)
    for st in per_shard_stats:
        total += np.asarray(st, dtype=np.int64).reshape(len(sam), 3)
    for f, s_path in enumerate(sam):
        if total[f, 0] == 0:
            quit_with_error(f'no alignments in "{s_path}"')
    _report_alignment_stats(
        sam, [tuple(int(x) for x in row) for row in total], careful)


def polishing_header() -> None:
    log.section_header("Polishing assembly sequences")
    log.explanation(
        "For each position in the assembly, Polypolish determines the read "
        "depth at that position and collects all aligned bases. It then "
        "polishes the assembly by looking for positions where the pileup "
        "unambiguously supports a different sequence than the assembly."
    )


def gather_headers(cols, file_runs, n_files: int):
    """Run headers concatenated in reference order: file-major, shard
    ranges ascending within each file (16 bytes per alignment: what a
    multi-process pod gathers).  ``cols`` holds each shard's (rc, rs,
    rl, rk) run columns, ``file_runs`` its runs per file."""
    per_shard = [(*c, np.concatenate(([0], np.cumsum(fr))))
                 for c, fr in zip(cols, file_runs)]
    out = [[], [], [], []]
    for f in range(n_files):
        for rc, rs, rl, rk, bounds in per_shard:
            lo, hi = int(bounds[f]), int(bounds[f + 1])
            for c, arr in zip(out, (rc, rs, rl, rk)):
                c.append(arr[lo:hi])
    return tuple(
        np.ascontiguousarray(np.concatenate(c), dtype=np.int32)
        for c in out
    )


def sparse_keys(sparse, base_vocab_len: int, remap):
    """A shard's sparse-tier (pos, local id, count) triples as (key,
    count) int64 arrays, key = pos * 2^31 + merged vocab id."""
    sp, sv, sc = sparse
    sv = sv.astype(np.int64)
    high = sv >= base_vocab_len
    if high.any():
        sv[high] = remap[sv[high] - base_vocab_len]
    return (sp.astype(np.int64) * (2 ** 31) + sv, sc.astype(np.int64))


def merge_sparse(keys, counts):
    """The shards' (key, count) arrays summed per key: sparse-tier
    (pos, id, count) int64 triples in (pos, id) order."""
    all_keys = np.concatenate(keys)
    if not all_keys.size:
        e = np.empty(0, dtype=np.int64)
        return e, e, e
    uk, inv = np.unique(all_keys, return_inverse=True)
    cnt = np.zeros(uk.shape[0], dtype=np.int64)
    np.add.at(cnt, inv, np.concatenate(counts))
    return uk // (2 ** 31), uk % (2 ** 31), cnt


def finish_contig(name, description, seq, counts, sparse, headers,
                  contig_idx, vocab, min_depth, fraction_valid,
                  fraction_invalid, out, debug_file) -> int:
    """One contig from its merged counts and sparse tier (its
    "Polishing" line already written): the exact
    depth (pp_depth_fold replays the gathered headers in reference
    order), thresholds, consensus and the output.  Returns the new
    length."""
    from polypolish_tpu_torch.native import binding

    P = counts.shape[1]
    depth = binding.depth_fold(*headers, contig_idx, P)
    valid_thr, invalid_thr, low_depth = compute_thresholds(
        depth, min_depth, fraction_valid, fraction_invalid
    )
    orig_id = _orig_ids_for_seq(seq, vocab)
    new_id, status = consensus_dense_numpy(
        counts, valid_thr, invalid_thr, low_depth, orig_id
    )
    return finish_sequence(
        name, description, seq, counts, depth, sparse, valid_thr,
        invalid_thr, new_id, status, orig_id, min_depth, vocab, out,
        debug_file,
    )
