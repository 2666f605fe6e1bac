"""Multi-process pod polish: one process per SAM ingest shard over a
``torch.distributed`` process group (counterpart of
polypolish_tpu/pipeline/pod_distributed.py, whose collectives are JAX's).

After ``parallel.multihost.initialize_distributed`` each process parses
only its read-group-snapped byte range of EVERY SAM file (the shards of
pipeline/pod.py, one per process), then the shards merge over gloo, on
host tensors:

- dense per-contig counts: ``_psum_i32``, an exact int32
  ``all_reduce(SUM)``;
- run HEADERS (16 bytes per alignment), sparse-tier triples, new vocab
  strings and per-file stats: ``_allgather_var`` (variable-length
  payloads travel padded to the longest, after their lengths);
- depth (order-sensitive f64, polish.rs:177): every process replays the
  gathered headers in reference order through ``pp_depth_fold``, a
  deterministic recomputation, bit-identical to a single process.

The gathered per-process arrays go through the merge of pipeline/pod.py
(``gather_headers``, ``merge_sparse``, ``finish_contig``), which the
in-process ``--pod-shards`` feeds with its local shards' arrays.

With POLYPOLISH_TPU_POD_DEVICE_VOTES=1 each process counts its shard's
votes on its own device (kernel A over its capped lane pack plus the
overflow vote kernel over the cap overflow,
``LanesPolisher.vote_counts``) instead of the host fold; only the
counts cross to the host for the
sum.  Every process computes the same consensus; process 0 writes the
FASTA and the --debug TSV, byte-identical to single-process
``polish()``.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time
from typing import List, Optional, TextIO, Tuple

import numpy as np
import torch
import torch.distributed as dist

from polypolish_tpu_torch import log
from polypolish_tpu_torch.parallel.multihost import (
    process_count,
    process_index,
)
from polypolish_tpu_torch.pipeline.pod import (
    finish_contig,
    gather_headers,
    merge_sparse,
    merge_vocabs,
    polishing_header,
    report_file_stats,
    sparse_keys,
    start_pod,
)
from polypolish_tpu_torch.pipeline.polish import (
    _create_debug_file,
    _pad_bucket,
    finished_message,
    resolve_device,
)
from polypolish_tpu_torch.vocab import DENSE_V, Vocab


def _device_votes() -> bool:
    """Pod device-vote mode (POLYPOLISH_TPU_POD_DEVICE_VOTES=1): each
    process counts its shard's votes on its own device with the lanes
    path instead of the host fold."""
    return os.environ.get("POLYPOLISH_TPU_POD_DEVICE_VOTES", "0") == "1"


# ---------------------------------------------------------------------
# collective helpers (host tensors over gloo; identity without a group)
# ---------------------------------------------------------------------

def _allgather_var(arr: np.ndarray) -> List[np.ndarray]:
    """All-gather a 1-D array whose length differs per process.

    Returns the per-process arrays in process order (the same list on
    every process).  Lengths travel first as one int64 per process;
    payloads travel as raw bytes padded to the longest, so every dtype,
    int64 included, comes back exact (the JAX package sends bytes
    because JAX truncates int64 on the wire by default; gloo would not,
    but one byte layout serves every dtype here)."""
    dtype = arr.dtype
    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
    if not dist.is_initialized():
        return [raw.copy().view(dtype)]
    world = dist.get_world_size()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lens, torch.tensor([raw.size], dtype=torch.int64))
    lens = [int(t) for t in lens]
    padded = np.zeros(max(1, max(lens)), dtype=np.uint8)
    padded[: raw.size] = raw
    out = [torch.empty(padded.size, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(out, torch.from_numpy(padded))
    return [out[i][: lens[i]].numpy().copy().view(dtype)
            for i in range(world)]


def _psum_i32(arr: np.ndarray) -> np.ndarray:
    """Elementwise sum of an identically shaped int32 array over the
    processes: ``all_reduce(SUM)`` on a host copy (exact: integer)."""
    t = torch.from_numpy(np.array(arr, dtype=np.int32, copy=True))
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def rank_device(device) -> torch.device:
    """This process's device: ``device`` as resolve_device checks it;
    "cuda" without an index takes card rank % card count, so ranks
    spread over the cards of a host (and share one on a one-card
    host)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


# ---------------------------------------------------------------------
# the distributed polish
# ---------------------------------------------------------------------

def _device_counts(shard, name: str, P: int, device) -> np.ndarray:
    """This process's (8, P) int32 counts of one contig on ``device``:
    its capped lane pack through kernel A, its overflow through the
    overflow vote kernel.  A shard with no alignment on the contig
    still gets a pack (all pad), so it votes zeros through the same
    kernels; no pack at all is a native failure, and raises."""
    from polypolish_tpu_torch.models.polisher import LanesPolisher

    p_pad = _pad_bucket(P)
    model = LanesPolisher(p_pad, device)
    pack = shard.lanes(name, model.r_sub, model.tile_w,
                       num_positions=p_pad, packed4=True, cap=True)
    if pack is None:
        raise RuntimeError(
            f"the native lane packer returned no pack for {name} "
            f"({p_pad} positions) on process {process_index()}: bad "
            f"arguments or out of memory"
        )
    try:
        counts = model.vote_counts(pack.vb, pack.block_tile, pack.ov_pos,
                                   pack.ov_vid)
        # the fetch waits for the device, so the pack outlives its reads
        return counts[:, :P].cpu().numpy()
    finally:
        pack.close()


def polish_pod_distributed(
    debug: Optional[str],
    fraction_invalid: float,
    fraction_valid: float,
    max_errors: int,
    min_depth: int,
    careful: bool,
    assembly: str,
    sam: List[str],
    out: Optional[TextIO] = None,
    n_threads: Optional[int] = None,
    device="cuda",
) -> List[Tuple[str, int]]:
    """Polish with the SAM ingest sharded over the process group's
    processes.  Process 0 writes the FASTA/--debug TSV; every process
    returns the (identical) new contig lengths.  Byte-identical to
    single-process polish().  ``device`` is checked up front and runs
    the device votes (POLYPOLISH_TPU_POD_DEVICE_VOTES=1)."""
    from polypolish_tpu_torch.native import runs as native_runs

    start_time = time.monotonic()
    dev = rank_device(device)
    n_procs = process_count()
    proc_idx = process_index()
    is_root = proc_idx == 0
    if out is None:
        out = sys.stdout
    with log.quiet() if not is_root else contextlib.nullcontext():
        seq_names, contigs, contig_names, contig_lens = start_pod(
            debug, fraction_invalid, fraction_valid, max_errors, min_depth,
            careful, assembly, sam,
        )
        local_vocab = Vocab()
        shard = native_runs.parse_runs(
            [str(s) for s in sam], contig_names, contig_lens, local_vocab,
            max_errors, careful, n_threads, proc_idx=proc_idx,
            n_procs=n_procs,
        )
        try:
            new_lengths = _merge_and_polish(
                shard, local_vocab, debug, fraction_invalid, fraction_valid,
                min_depth, careful, sam, seq_names, contigs, contig_names,
                contig_lens, out if is_root else io.StringIO(), is_root,
                dev,
            )
        finally:
            shard.close()
        finished_message(debug, new_lengths, start_time)
        return new_lengths


def _merge_and_polish(shard, local_vocab, debug, fraction_invalid,
                      fraction_valid, min_depth, careful, sam, seq_names,
                      contigs, contig_names, contig_lens, sink, is_root,
                      dev) -> List[Tuple[str, int]]:
    """The pod's exchange over the group (vocab strings, file stats, run
    headers, then per contig the counts and the sparse tier) into the
    merge of pipeline/pod.py, and the contigs' output."""
    n_procs = process_count()
    shard_vocabs = []
    vocab_blob = "\n".join(local_vocab.strings[DENSE_V:]).encode("latin-1")
    for b in _allgather_var(np.frombuffer(vocab_blob, dtype=np.uint8)):
        v = Vocab()
        s = b.tobytes().decode("latin-1")
        if s:
            for token in s.split("\n"):
                v.intern(token)
        shard_vocabs.append(v)
    vocab, remaps = merge_vocabs(shard_vocabs)
    remap = remaps[process_index()]

    report_file_stats(sam, _allgather_var(
        np.asarray(shard.file_stats, dtype=np.int64).reshape(-1)), careful)
    # one device per process
    log.eprint(
        f"Pod mode: SAM ingest sharded over {n_procs} processes "
        f"({n_procs} devices)"
    )
    log.eprint()

    # 16 bytes per alignment on the wire
    cols = [_allgather_var(np.ascontiguousarray(col))
            for col in shard.raw()[:4]]
    headers = gather_headers(
        list(zip(*cols)),
        _allgather_var(np.asarray(shard.file_runs, dtype=np.int64)),
        len(sam),
    )

    polishing_header()
    debug_file = _create_debug_file(debug) if is_root else None
    new_lengths = []
    try:
        for name, description in seq_names:
            P = contig_lens[name]
            log.eprint(f"Polishing {name} ({log.thousands(P)} bp):")
            if _device_votes():
                counts_local = _device_counts(shard, name, P, dev)
                sparse = shard.sparse(name)
            else:
                counts_local, _d, sparse = shard.fold(name)
            keys, cnts = sparse_keys(sparse, shard.base_vocab_len, remap)
            new_lengths.append((name, finish_contig(
                name, description, contigs[name].seq,
                _psum_i32(counts_local),
                merge_sparse(_allgather_var(keys), _allgather_var(cnts)),
                headers, contig_names.index(name), vocab, min_depth,
                fraction_valid, fraction_invalid, sink, debug_file,
            )))
    finally:
        if debug_file is not None:
            debug_file.close()
    return new_lengths
