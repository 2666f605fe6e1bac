"""ctypes binding for the native SAM packer.

The subset of the JAX package's binding that the ``polish`` and
``filter`` subcommands call, over the port's own copy of its C++ engine
(sam_packer.cc, verbatim): the run parse, the fold / window fold /
sparse / chunks / lanes / lanes-mesh views, the chunk packer, the host
consensus, the sequential f64 sums, the --debug TSV writer, and the
filter's pair quick-parse and verdict rewrite.  native/loader.py builds
the library.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from polypolish_tpu_torch.errors import quit_with_error
from polypolish_tpu_torch.native import loader

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _PPChunksView(ctypes.Structure):
    _fields_ = [
        ("chunk_pos", ctypes.POINTER(ctypes.c_int32)),
        ("chunk_vocab", ctypes.POINTER(ctypes.c_int32)),
        ("chunk_tile", ctypes.POINTER(ctypes.c_int32)),
        ("n_chunks", ctypes.c_int64),
        ("n_tiles", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
    ]


class _PPQuickView(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.POINTER(ctypes.c_int32) * 2),
        ("ref_id", ctypes.POINTER(ctypes.c_int32) * 2),
        ("start", ctypes.POINTER(ctypes.c_int64) * 2),
        ("end", ctypes.POINTER(ctypes.c_int64) * 2),
        ("name_id", ctypes.POINTER(ctypes.c_int64) * 2),
        ("n", ctypes.c_int64 * 2),
        ("n_names", ctypes.c_int64 * 2),
        ("line_start", ctypes.POINTER(ctypes.c_int64) * 2),
        ("line_end", ctypes.POINTER(ctypes.c_int64) * 2),
        ("status", ctypes.c_int),
        ("error", ctypes.c_char_p),
        ("handle", ctypes.c_void_p),
    ]


class _PPRewriteView(ctypes.Structure):
    _fields_ = [
        ("pass_count", ctypes.c_int64),
        ("fail_count", ctypes.c_int64),
        ("status", ctypes.c_int),
        ("error", ctypes.c_char_p),
        ("handle", ctypes.c_void_p),
    ]


class _PPDebugView(ctypes.Structure):
    _fields_ = [
        ("bytes_written", ctypes.c_int64),
        ("status", ctypes.c_int),
        ("error", ctypes.c_char_p),
        ("handle", ctypes.c_void_p),
    ]


class _PPRunsView(ctypes.Structure):
    _fields_ = [
        ("run_contig", ctypes.POINTER(ctypes.c_int32)),
        ("run_start", ctypes.POINTER(ctypes.c_int32)),
        ("run_len", ctypes.POINTER(ctypes.c_int32)),
        ("run_k", ctypes.POINTER(ctypes.c_int32)),
        ("n_runs", ctypes.c_int64),
        ("vocab_bytes", ctypes.POINTER(ctypes.c_uint8)),
        ("n_events", ctypes.c_int64),   # PHYSICAL vocab-byte count
        ("run_poff", ctypes.POINTER(ctypes.c_int64)),
        ("ov_idx", ctypes.POINTER(ctypes.c_int64)),
        ("ov_vid", ctypes.POINTER(ctypes.c_int32)),
        ("n_overflow", ctypes.c_int64),
        ("new_vocab", ctypes.c_void_p),
        ("new_vocab_len", ctypes.c_int64),
        ("n_new_vocab", ctypes.c_int64),
        ("file_alignments", ctypes.POINTER(ctypes.c_int64)),
        ("file_used", ctypes.POINTER(ctypes.c_int64)),
        ("file_reads", ctypes.POINTER(ctypes.c_int64)),
        ("file_runs", ctypes.POINTER(ctypes.c_int64)),
        ("file_events", ctypes.POINTER(ctypes.c_int64)),
        ("n_files", ctypes.c_int64),
        ("status", ctypes.c_int),
        ("error", ctypes.c_char_p),
        ("handle", ctypes.c_void_p),
    ]


class _PPFoldView(ctypes.Structure):
    _fields_ = [
        ("sp_pos", ctypes.POINTER(ctypes.c_int64)),
        ("sp_vid", ctypes.POINTER(ctypes.c_int32)),
        ("sp_cnt", ctypes.POINTER(ctypes.c_int32)),
        ("n_sparse", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
    ]


class _PPChunks2View(ctypes.Structure):
    _fields_ = [
        ("chunk_pos", ctypes.POINTER(ctypes.c_uint8)),
        ("chunk_vocab", ctypes.POINTER(ctypes.c_uint8)),
        ("chunk_tile", ctypes.POINTER(ctypes.c_int32)),
        ("n_chunks", ctypes.c_int64),
        ("n_tiles", ctypes.c_int64),
        ("n_dense_events", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
    ]


class _PPLanesView(ctypes.Structure):
    _fields_ = [
        ("vb", ctypes.POINTER(ctypes.c_uint8)),
        ("block_tile", ctypes.POINTER(ctypes.c_int32)),
        ("n_blocks", ctypes.c_int64),
        ("n_tiles", ctypes.c_int64),
        ("n_events", ctypes.c_int64),
        ("ov_pos", ctypes.POINTER(ctypes.c_int32)),
        ("ov_vid", ctypes.POINTER(ctypes.c_uint8)),
        ("n_overflow", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
    ]


class _PPLanesMeshView(ctypes.Structure):
    _fields_ = [
        ("vb", ctypes.POINTER(ctypes.c_uint8)),
        ("block_tile", ctypes.POINTER(ctypes.c_int32)),
        ("n_blocks", ctypes.c_int64),
        ("n_tiles", ctypes.c_int64),
        ("p_shard", ctypes.c_int64),
        ("n_events", ctypes.c_int64),
        ("handle", ctypes.c_void_p),
    ]


def _declare(lib: ctypes.CDLL) -> None:
    P = ctypes.POINTER
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    lib.pp_prepare_chunks.restype = P(_PPChunksView)
    lib.pp_prepare_chunks.argtypes = [
        P(i64),                             # pos
        P(i32),                             # vocab
        i64,                                # n events
        i64,                                # num_positions
        i32,                                # tile_p
        i32,                                # e_sub
        i32,                                # n_threads
    ]
    lib.pp_free_chunks.argtypes = [P(_PPChunksView)]
    lib.pp_free_chunks.restype = None
    lib.pp_debug_tsv.restype = P(_PPDebugView)
    lib.pp_debug_tsv.argtypes = [
        ctypes.c_int,                       # fd
        ctypes.c_char_p,                    # contig name
        ctypes.c_char_p,                    # sequence
        i64,                                # seq_len
        P(f64),                             # depth
        P(i32),                             # invalid_thr
        P(i32),                             # valid_thr
        P(i32),                             # counts (8, P) row-major
        P(i64),                             # sparse pos (ascending)
        P(i32),                             # sparse vocab id
        P(i32),                             # sparse count
        i64,                                # n_sparse
        P(i32),                             # status
        P(i32),                             # new_id
        i32,                                # st_changed
        ctypes.c_char_p,                    # vocab blob
        i64,                                # n_vocab
        ctypes.c_char_p,                    # status blob
        i64,                                # n_status
    ]
    lib.pp_free_debug.argtypes = [P(_PPDebugView)]
    lib.pp_free_debug.restype = None
    lib.pp_parse_runs.restype = P(_PPRunsView)
    lib.pp_parse_runs.argtypes = [
        ctypes.c_char_p,                    # filenames '\n'-joined
        i64,                                # n_files
        ctypes.c_char_p,                    # contig names '\n'-joined
        P(i64),                             # contig lengths
        i64,                                # n_contigs
        ctypes.c_char_p,                    # vocab '\n'-joined
        i64,                                # n_vocab
        i64,                                # max_errors
        i32,                                # careful
        i32,                                # n_threads
        i32,                                # proc_idx (pod mode)
        i32,                                # n_procs
    ]
    lib.pp_free_runs.argtypes = [P(_PPRunsView)]
    lib.pp_free_runs.restype = None
    lib.pp_madvise_huge.argtypes = [ctypes.c_void_p, i64]
    lib.pp_madvise_huge.restype = None
    lib.pp_sum_f64_seq.argtypes = [P(f64), i64]
    lib.pp_sum_f64_seq.restype = f64
    lib.pp_sum_f64_seq_init.argtypes = [P(f64), i64, f64]
    lib.pp_sum_f64_seq_init.restype = f64
    lib.pp_fold_window.restype = None
    lib.pp_fold_window.argtypes = [
        P(_PPRunsView),
        i32,                                # contig id
        i64,                                # w_lo
        i64,                                # w_hi
        ctypes.c_void_p,                    # counts_out (8, W) or NULL
        P(f64),                             # depth_out (W)
        i32,                                # parallel
        i32,                                # min_depth
        f64,                                # fraction_valid
        f64,                                # fraction_invalid
        ctypes.c_void_p,                    # valid_out (W)
        ctypes.c_void_p,                    # invalid_out (W)
        ctypes.c_void_p,                    # low_out (W)
    ]
    lib.pp_quick_parse_pair.restype = P(_PPQuickView)
    lib.pp_quick_parse_pair.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.pp_free_quick.argtypes = [P(_PPQuickView)]
    lib.pp_free_quick.restype = None
    lib.pp_rewrite_sam.restype = P(_PPRewriteView)
    lib.pp_rewrite_sam.argtypes = [
        ctypes.c_char_p,                    # in filename
        ctypes.c_char_p,                    # out filename
        P(ctypes.c_uint8),                  # verdicts (0/1 per record)
        i64,                                # n_verdicts
        P(i64),                             # line_end offsets or NULL
    ]
    lib.pp_free_rewrite.argtypes = [P(_PPRewriteView)]
    lib.pp_free_rewrite.restype = None
    lib.pp_fold_contig.restype = P(_PPFoldView)
    lib.pp_fold_contig.argtypes = [
        P(_PPRunsView),
        i32,                                # contig id
        i64,                                # P
        ctypes.c_void_p,                    # counts_out (8*P) or NULL
        P(f64),                             # depth_out (P)
        i32,                                # parallel
        i32,                                # min_depth
        f64,                                # fraction_valid
        f64,                                # fraction_invalid
        ctypes.c_void_p,                    # valid_out (P) or NULL
        ctypes.c_void_p,                    # invalid_out (P) or NULL
        ctypes.c_void_p,                    # low_out (P) or NULL
    ]
    lib.pp_free_fold.argtypes = [P(_PPFoldView)]
    lib.pp_free_fold.restype = None
    lib.pp_sparse_contig.restype = P(_PPFoldView)
    lib.pp_sparse_contig.argtypes = [P(_PPRunsView), i32]
    lib.pp_chunks_from_runs.restype = P(_PPChunks2View)
    lib.pp_chunks_from_runs.argtypes = [
        P(_PPRunsView),
        i32,                                # contig id
        i64,                                # P
        i32,                                # tile_p
        i32,                                # e_sub
        i32,                                # n_threads
    ]
    lib.pp_free_chunks2.argtypes = [P(_PPChunks2View)]
    lib.pp_free_chunks2.restype = None
    lib.pp_lanes_from_runs.restype = P(_PPLanesView)
    lib.pp_lanes_from_runs.argtypes = [
        P(_PPRunsView),
        i32,                                # contig id
        i64,                                # P
        i32,                                # r_sub
        i32,                                # tile_w
        i32,                                # n_threads
        i32,                                # layout (0 rows, 1 packed4)
        i32,                                # cap (depth-stratified rows)
        i64,                                # w_lo (window origin)
    ]
    lib.pp_free_lanes.argtypes = [P(_PPLanesView)]
    lib.pp_free_lanes.restype = None
    lib.pp_lanes_mesh.restype = P(_PPLanesMeshView)
    lib.pp_lanes_mesh.argtypes = [
        P(_PPRunsView),
        i32,                                # contig id
        i64,                                # P
        i32,                                # r_sub
        i32,                                # tile_w
        i32,                                # n_data
        i32,                                # n_pos
        i32,                                # n_threads
        i32,                                # layout (0 rows, 1 packed4)
    ]
    lib.pp_free_lanes_mesh.argtypes = [P(_PPLanesMeshView)]
    lib.pp_free_lanes_mesh.restype = None
    lib.pp_depth_fold.restype = None
    lib.pp_depth_fold.argtypes = [
        P(i32),                             # run_contig
        P(i32),                             # run_start
        P(i32),                             # run_len
        P(i32),                             # run_k
        i64,                                # n_runs
        i32,                                # contig id
        i64,                                # P
        P(f64),                             # depth_out
    ]
    lib.pp_consensus_dense.restype = None
    lib.pp_consensus_dense.argtypes = [
        P(i32),                             # counts (8, P) row-major
        P(i32),                             # valid_thr
        P(i32),                             # invalid_thr
        P(ctypes.c_uint8),                  # low_depth
        P(i32),                             # orig_id
        i64,                                # P
        P(i32),                             # new_id out
        P(i32),                             # status out
        i32,                                # n_threads
    ]


def load_library() -> ctypes.CDLL:
    """The native library, built on first use; raises if the build
    fails (the port has no pure-Python SAM path)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(loader.build())
            _declare(lib)
            _lib = lib
        return _lib


def prepare_chunks_native(pos, vocab, num_positions, tile_p, e_sub,
                          n_threads=None):
    """C++ parallel stable counting-sort chunk prep (layout-identical to
    the numpy version in ops/vote_chunks.py for every thread count)."""
    lib = load_library()
    if n_threads is None:
        n_threads = default_threads()
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    vocab = np.ascontiguousarray(vocab, dtype=np.int32)
    view = lib.pp_prepare_chunks(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vocab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pos.shape[0], num_positions, tile_p, e_sub, n_threads,
    )
    try:
        v = view.contents
        n_chunks = int(v.n_chunks)
        n_tiles = int(v.n_tiles)
        e_b = e_sub * 128
        chunk_pos = np.ctypeslib.as_array(
            v.chunk_pos, shape=(n_chunks * e_b,)
        ).copy().reshape(n_chunks * e_sub, 128)
        chunk_vocab = np.ctypeslib.as_array(
            v.chunk_vocab, shape=(n_chunks * e_b,)
        ).copy().reshape(n_chunks * e_sub, 128)
        chunk_tile = np.ctypeslib.as_array(
            v.chunk_tile, shape=(n_chunks,)
        ).copy()
        return chunk_pos, chunk_vocab, chunk_tile, n_tiles
    finally:
        lib.pp_free_chunks(view)


def debug_tsv_native(
    debug_file, name: str, seq: str, depth, invalid_thr, valid_thr,
    counts, sp_pos, sp_vid, sp_cnt, status, new_id, st_changed: int,
    vocab_strings, status_strings,
) -> int:
    """Stream one contig's --debug TSV lines to ``debug_file`` via the
    native writer (byte-identical to pipeline/polish.py's Python loop).

    ``counts`` is the dense (8, seq_len) count tensor; sparse-tier
    entries arrive as three parallel arrays sorted ascending by position.
    Returns the number of bytes written.
    """
    lib = load_library()
    seq_b = seq.encode("latin-1")
    seq_len = len(seq)
    depth = np.ascontiguousarray(depth, dtype=np.float64)
    invalid_thr = np.ascontiguousarray(invalid_thr, dtype=np.int32)
    valid_thr = np.ascontiguousarray(valid_thr, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    if counts.shape != (8, seq_len):
        raise ValueError(f"counts shape {counts.shape} != (8, {seq_len})")
    sp_pos = np.ascontiguousarray(sp_pos, dtype=np.int64)
    sp_vid = np.ascontiguousarray(sp_vid, dtype=np.int32)
    sp_cnt = np.ascontiguousarray(sp_cnt, dtype=np.int32)
    status = np.ascontiguousarray(status, dtype=np.int32)
    new_id = np.ascontiguousarray(new_id, dtype=np.int32)
    vocab_blob = "\n".join(
        _transfer_safe(s) for s in vocab_strings
    ).encode("latin-1")
    status_blob = "\n".join(status_strings).encode("latin-1")

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    debug_file.flush()
    view = lib.pp_debug_tsv(
        debug_file.fileno(), name.encode("utf-8"), seq_b, seq_len,
        ptr(depth, ctypes.c_double),
        ptr(invalid_thr, ctypes.c_int32), ptr(valid_thr, ctypes.c_int32),
        ptr(counts, ctypes.c_int32),
        ptr(sp_pos, ctypes.c_int64), ptr(sp_vid, ctypes.c_int32),
        ptr(sp_cnt, ctypes.c_int32), sp_pos.shape[0],
        ptr(status, ctypes.c_int32), ptr(new_id, ctypes.c_int32),
        st_changed, vocab_blob, len(vocab_strings),
        status_blob, len(status_strings),
    )
    try:
        v = view.contents
        if v.status != 0:
            quit_with_error(v.error.decode("utf-8", errors="replace"))
        return int(v.bytes_written)
    finally:
        lib.pp_free_debug(view)


def consensus_dense_native(counts, valid_thr, invalid_thr, low_depth,
                           orig_id, n_threads: int = 2):
    """C++ twin of ops.consensus.consensus_dense_numpy: one blocked,
    threaded pass over the row-major (8, P) counts.  Returns
    (new_id int32, status int32)."""
    lib = load_library()
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    P = counts.shape[1]
    valid_thr = np.ascontiguousarray(valid_thr, dtype=np.int32)
    invalid_thr = np.ascontiguousarray(invalid_thr, dtype=np.int32)
    low = np.ascontiguousarray(
        np.asarray(low_depth, dtype=np.bool_).view(np.uint8)
    )
    orig_id = np.ascontiguousarray(orig_id, dtype=np.int32)
    from polypolish_tpu_torch.native.runs import _pooled_buffer

    new_id = _pooled_buffer("new_id", (P,), np.int32)
    status = _pooled_buffer("status", (P,), np.int32)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    lib.pp_consensus_dense(
        ptr(counts, ctypes.c_int32), ptr(valid_thr, ctypes.c_int32),
        ptr(invalid_thr, ctypes.c_int32), ptr(low, ctypes.c_uint8),
        ptr(orig_id, ctypes.c_int32), P,
        ptr(new_id, ctypes.c_int32), ptr(status, ctypes.c_int32),
        n_threads,
    )
    return new_id, status


def sum_f64_seq(arr) -> float:
    """Strict sequential left-fold sum of a float64 array — bit-equal
    to float(np.cumsum(arr)[-1]) without the 8*P temporary."""
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    if arr.size == 0:
        return 0.0
    lib = load_library()
    return float(lib.pp_sum_f64_seq(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), arr.size
    ))


def sum_f64_seq_init(arr, init: float) -> float:
    """Strict sequential left-fold continuing from ``init`` (the
    windowed paths' depth total: one fold across all windows)."""
    lib = load_library()
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return float(lib.pp_sum_f64_seq_init(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), arr.size,
        float(init),
    ))


def quick_parse_pair(file1, file2):
    """Quick-parse both paired SAM files (plain, gzip or BAM) with shared
    name/ref interning.

    Returns a list of two dicts with numpy columns (flags, ref_id,
    start, end, name_id, line_end) plus 'n_names'; raises
    PolypolishError on the reference's fatal conditions."""
    lib = load_library()
    view = lib.pp_quick_parse_pair(os.fsencode(file1), os.fsencode(file2))
    try:
        v = view.contents
        if v.status != 0:
            quit_with_error(v.error.decode("utf-8", errors="replace"))
        out = []
        for i in range(2):
            n = int(v.n[i])

            def arr(ptr, dtype):
                if n == 0:
                    return np.empty(0, dtype=dtype)
                return np.ctypeslib.as_array(ptr, shape=(n,)).copy()

            out.append({
                "flags": arr(v.flags[i], np.int32),
                "ref_id": arr(v.ref_id[i], np.int32),
                "start": arr(v.start[i], np.int64),
                "end": arr(v.end[i], np.int64),
                "name_id": arr(v.name_id[i], np.int64),
                "n_names": int(v.n_names[i]),
                # aligned-record line-end offsets: the verdict rewrite
                # then copies the input without scanning it again
                "line_end": arr(v.line_end[i], np.int64),
            })
        return out
    finally:
        lib.pp_free_quick(view)


def rewrite_sam_native(in_filename, out_filename, verdicts,
                       line_end=None):
    """Native SAM re-stream of the filter subcommand: copies the input,
    tagging aligned records whose verdict is False with ``ZP:Z:fail``
    (filter.rs:296-343).  ``line_end``: the aligned records' line-end
    offsets from quick_parse_pair, which make the rewrite scan-free.
    Returns (pass_count, fail_count)."""
    lib = load_library()
    v8 = np.ascontiguousarray(verdicts, dtype=np.uint8)
    if line_end is not None and len(line_end) == v8.shape[0]:
        le = np.ascontiguousarray(line_end, dtype=np.int64)
        le_ptr = le.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    else:
        le_ptr = None
    view = lib.pp_rewrite_sam(
        os.fsencode(in_filename), os.fsencode(out_filename),
        v8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), v8.shape[0],
        le_ptr,
    )
    try:
        v = view.contents
        if v.status != 0:
            quit_with_error(v.error.decode("utf-8", errors="replace"))
        return int(v.pass_count), int(v.fail_count)
    finally:
        lib.pp_free_rewrite(view)


def madvise_huge_np(*arrays) -> None:
    """Request transparent huge pages for freshly allocated numpy
    buffers BEFORE first touch (hosts running THP in madvise mode pay a
    slow 4 KB minor fault per page otherwise)."""
    lib = load_library()
    for a in arrays:
        if a is not None and a.nbytes >= (4 << 20):
            lib.pp_madvise_huge(ctypes.c_void_p(a.ctypes.data), a.nbytes)


def _transfer_safe(s: str) -> str:
    # reserved vocab placeholders contain NUL which C strings can't carry
    return s.replace("\x00", "\x01")


def default_threads() -> int:
    env = os.environ.get("POLYPOLISH_TPU_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(os.cpu_count() or 1, 16))


def depth_fold(run_contig, run_start, run_len, run_k, contig_id: int,
               num_positions: int) -> np.ndarray:
    """(P,) f64 depth of one contig replayed from run headers
    (pp_depth_fold): the reference's sequential left-fold per position
    when the headers come in reference order (the pod's merge)."""
    lib = load_library()
    cols = [np.ascontiguousarray(a, dtype=np.int32)
            for a in (run_contig, run_start, run_len, run_k)]
    depth = np.empty(num_positions, dtype=np.float64)
    lib.pp_depth_fold(
        *(a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for a in cols),
        cols[0].shape[0], contig_id, num_positions,
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return depth
