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
from typing import Dict, List, Optional, TextIO, Tuple

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
    check_option_values(fraction_invalid, fraction_valid)
    check_inputs_exist(assembly, sam)
    starting_message(
        debug, fraction_invalid, fraction_valid, max_errors, min_depth,
        careful, assembly, sam,
    )

    seq_names, contigs = load_assembly(assembly)
    contig_names = list(contigs)
    contig_lens = {n: c.length for n, c in contigs.items()}

    log.section_header("Loading alignments")
    shards, shard_vocabs = parse_pod_shards(
        sam, contig_names, contig_lens, max_errors, careful, n_procs,
        n_threads,
    )
    vocab, remaps = merge_vocabs(shard_vocabs)

    # merged per-file stats; the whole-file zero-alignment fatal was
    # deferred by the shard parses (a RANGE may be empty)
    stats_list = []
    for f, s_path in enumerate(sam):
        a = sum(sh.file_stats[f][0] for sh in shards)
        u = sum(sh.file_stats[f][1] for sh in shards)
        r = sum(sh.file_stats[f][2] for sh in shards)
        if a == 0:
            quit_with_error(f'no alignments in "{s_path}"')
        stats_list.append((a, u, r))
    _report_alignment_stats(sam, stats_list, careful)
    log.eprint(
        f"Pod mode: SAM ingest sharded over {n_procs} byte-range shards"
    )
    log.eprint()

    headers = gather_headers(shards, len(sam))

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
            seq = contigs[name].seq
            log.eprint(f"Polishing {name} ({log.thousands(len(seq))} bp):")
            counts, depth, sparse = merge_contig(
                shards, remaps, headers, name, contig_names,
                contig_lens[name],
            )
            valid_thr, invalid_thr, low_depth = compute_thresholds(
                depth, min_depth, fraction_valid, fraction_invalid
            )
            orig_id = _orig_ids_for_seq(seq, vocab)
            new_id, status = consensus_dense_numpy(
                counts, valid_thr, invalid_thr, low_depth, orig_id
            )
            new_length = finish_sequence(
                name, description, seq, counts, depth, sparse,
                valid_thr, invalid_thr, new_id, status, orig_id,
                min_depth, vocab, out, debug_file,
            )
            new_lengths.append((name, new_length))
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


def gather_headers(shards, n_files: int):
    """Run headers concatenated in reference order: file-major, shard
    ranges ascending within each file (16 bytes per alignment: what a
    multi-process pod gathers)."""
    per_shard = []
    for sh in shards:
        rc, rs, rl, rk, _vb, _oi, _ov, _poff = sh.raw()
        bounds = np.concatenate(([0], np.cumsum(sh.file_runs)))
        per_shard.append((rc, rs, rl, rk, bounds))
    cols = [[], [], [], []]
    for f in range(n_files):
        for rc, rs, rl, rk, bounds in per_shard:
            lo, hi = int(bounds[f]), int(bounds[f + 1])
            for c, arr in zip(cols, (rc, rs, rl, rk)):
                c.append(arr[lo:hi])
    return tuple(
        np.ascontiguousarray(np.concatenate(c), dtype=np.int32)
        for c in cols
    )


def merge_contig(shards, remaps, headers, name, contig_names, P):
    """Merged (counts, depth, sparse) for one contig: integer sums over
    shard folds + the exact header-replay depth."""
    from polypolish_tpu_torch.native import binding

    counts = np.zeros((DENSE_V, P), dtype=np.int32)
    sparse_acc: Dict[int, int] = {}
    for sh, remap in zip(shards, remaps):
        c, _d, (sp, sv, sc) = sh.fold(name)
        counts += c
        if sp.size:
            sv = sv.astype(np.int64)
            high = sv >= sh.base_vocab_len
            if high.any():
                sv = sv.copy()
                sv[high] = remap[sv[high] - sh.base_vocab_len]
            for p, v, cnt in zip(sp.tolist(), sv.tolist(), sc.tolist()):
                key = p * (2**31) + v
                sparse_acc[key] = sparse_acc.get(key, 0) + cnt
    if sparse_acc:
        keys = np.asarray(sorted(sparse_acc), dtype=np.int64)
        sparse = (
            keys // (2**31), keys % (2**31),
            np.asarray([sparse_acc[int(k)] for k in keys], dtype=np.int64),
        )
    else:
        e = np.empty(0, dtype=np.int64)
        sparse = (e, e, e)

    rc, rs, rl, rk = headers
    depth = binding.depth_fold(rc, rs, rl, rk, contig_names.index(name), P)
    return counts, depth, sparse
