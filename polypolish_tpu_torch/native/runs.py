"""Run-based native polish pipeline (the host engine).

One ``pp_parse_runs`` call parses ALL SAM files (parallel byte ranges
per file, files in order) into per-alignment runs: a 16-byte header
(contig, ref_start, n_events, k) plus one vocab byte per event.  Per
contig the runs are then

- folded in C++ into the (8, P) dense count tensor + sequential-exact
  f64 depth + sparse tier (host backend; reference pileup.rs:56-65
  semantics) — or, with ``want_counts=False``, into the depth and
  thresholds alone (device backend); whole, or one position window at
  a time for huge contigs (``fold_window``), and
- packed in C++ into the lane-aligned layout of the lanes vote kernel
  (``lanes``, whole or from a window origin ``w_lo``), with the
  cap-overflow events alongside.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from polypolish_tpu_torch.errors import quit_with_error
from polypolish_tpu_torch.vocab import DENSE_V, Vocab


def _as_np(ptr, n, dtype):
    if n == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(int(n),))


_tls = threading.local()


def _pooled_buffer(key, shape, dtype) -> np.ndarray:
    """Thread-local reusable output buffer (THP-madvised on first
    allocation).  Every fold fully rewrites these arrays, and within one
    thread a contig's arrays are consumed (consensus + FASTA/TSV write)
    before the next fold of the same shape starts, so reuse is safe —
    callers that keep a result past the next fold must copy it."""
    from polypolish_tpu_torch.native import binding

    pool = getattr(_tls, "pool", None)
    if pool is None:
        pool = _tls.pool = {}
    buf = pool.get(key)
    if buf is None or buf.shape != shape:
        buf = np.empty(shape, dtype=dtype)
        binding.madvise_huge_np(buf)
        pool[key] = buf
    return buf


class ParsedRuns:
    """Owns a PPRunsView; exposes per-contig fold/sparse/chunks/lanes."""

    def __init__(self, lib, view, contig_names: List[str],
                 contig_lens: Dict[str, int]):
        self._lib = lib
        self._view = view
        self.contig_names = contig_names
        self.contig_lens = contig_lens
        v = view.contents
        self.base_vocab_len = DENSE_V  # overwritten by parse_runs
        self.file_stats: List[Tuple[int, int, int]] = [
            (int(v.file_alignments[i]), int(v.file_used[i]),
             int(v.file_reads[i]))
            for i in range(int(v.n_files))
        ]
        # runs per file, in file order (the pod merge cuts the headers
        # of each file out of every shard)
        self.file_runs: List[int] = [
            int(v.file_runs[i]) for i in range(int(v.n_files))
        ]
        # the folds run on two threads unless this is False: batch mode
        # turns it off when one thread parses each genome (the two-thread
        # fold scans every run twice, more total CPU on busy cores)
        self.fold_parallel = True

    # -- lifecycle ----------------------------------------------------
    def close(self) -> None:
        if self._view is not None:
            self._lib.pp_free_runs(self._view)
            self._view = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass

    # -- per-contig consumers ------------------------------------------
    def fold(self, contig_name: str, want_counts: bool = True,
             thresholds=None):
        """Returns (counts (8,P) int32 or None, depth (P,) f64, sparse)
        where sparse = (pos i64, vid i32, cnt i64) sorted ascending.

        With thresholds=(min_depth, fraction_valid, fraction_invalid),
        returns a 4th element (valid_thr i32, invalid_thr i32,
        low_depth bool) computed in the same C++ pass as depth
        (bit-identical to ops.consensus.compute_thresholds).

        counts, depth and the thresholds are pooled buffers that the
        next fold on this thread overwrites.  The C++ fold runs on two
        threads unless ``fold_parallel`` is False."""
        cid = self.contig_names.index(contig_name)
        P = self.contig_lens[contig_name]
        depth = _pooled_buffer("depth", (P,), np.float64)
        counts = _pooled_buffer("counts", (DENSE_V, P), np.int32) \
            if want_counts else None
        if thresholds is not None:
            min_depth, f_valid, f_invalid = thresholds
            valid = _pooled_buffer("valid", (P,), np.int32)
            invalid = _pooled_buffer("invalid", (P,), np.int32)
            low = _pooled_buffer("low", (P,), np.uint8)
            thr_args = (
                int(min_depth), float(f_valid), float(f_invalid),
                valid.ctypes.data_as(ctypes.c_void_p),
                invalid.ctypes.data_as(ctypes.c_void_p),
                low.ctypes.data_as(ctypes.c_void_p),
            )
        else:
            thr_args = (0, 0.0, 0.0, None, None, None)
        fv = self._lib.pp_fold_contig(
            self._view, cid, P,
            counts.ctypes.data_as(ctypes.c_void_p) if want_counts else None,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1 if self.fold_parallel else 0, *thr_args,
        )
        try:
            f = fv.contents
            n = int(f.n_sparse)
            sparse = (
                _as_np(f.sp_pos, n, np.int64).copy(),
                _as_np(f.sp_vid, n, np.int32).copy(),
                _as_np(f.sp_cnt, n, np.int32).copy().astype(np.int64),
            )
        finally:
            self._lib.pp_free_fold(fv)
        if thresholds is not None:
            return counts, depth, sparse, (valid, invalid,
                                           low.view(np.bool_))
        return counts, depth, sparse

    def fold_window(self, contig_name: str, w_lo: int, w_hi: int,
                    thresholds, want_counts: bool = True):
        """The fold of positions [w_lo, w_hi) only (pp_fold_window), for
        huge contigs: returns (counts (8, W) int32, or None with
        want_counts=False, depth (W,) f64, (valid_thr i32, invalid_thr
        i32, low_depth bool)), W = w_hi - w_lo; the working set is O(W)
        instead of O(P).  The sparse tier comes from .sparse() once,
        outside the window loop.  Every array is a pooled buffer keyed
        by W that the next window fold of that width overwrites."""
        cid = self.contig_names.index(contig_name)
        W = w_hi - w_lo
        counts = _pooled_buffer(("w_counts", W), (DENSE_V, W), np.int32) \
            if want_counts else None
        depth = _pooled_buffer(("w_depth", W), (W,), np.float64)
        valid = _pooled_buffer(("w_valid", W), (W,), np.int32)
        invalid = _pooled_buffer(("w_invalid", W), (W,), np.int32)
        low = _pooled_buffer(("w_low", W), (W,), np.uint8)
        min_depth, f_valid, f_invalid = thresholds
        self._lib.pp_fold_window(
            self._view, cid, w_lo, w_hi,
            counts.ctypes.data_as(ctypes.c_void_p)
            if counts is not None else None,
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1 if self.fold_parallel else 0,
            int(min_depth), float(f_valid), float(f_invalid),
            valid.ctypes.data_as(ctypes.c_void_p),
            invalid.ctypes.data_as(ctypes.c_void_p),
            low.ctypes.data_as(ctypes.c_void_p),
        )
        return counts, depth, (valid, invalid, low.view(np.bool_))

    def sparse(self, contig_name: str):
        """Sparse-tier counts (pos i64, vid i64, cnt i64, ascending) for
        one contig WITHOUT a dense fold (pp_sparse_contig — zero-copy-
        aware: shared byte ranges count once per referencing run).
        Valid because with a fresh base vocab (<= DENSE_V strings) every
        sparse event travels via the overflow list; falls back to
        fold() otherwise."""
        if self.base_vocab_len > DENSE_V:
            return self.fold(contig_name, want_counts=True)[2]
        cid = self.contig_names.index(contig_name)
        fv = self._lib.pp_sparse_contig(self._view, cid)
        try:
            f = fv.contents
            n = int(f.n_sparse)
            return (
                _as_np(f.sp_pos, n, np.int64).copy(),
                _as_np(f.sp_vid, n, np.int32).copy().astype(np.int64),
                _as_np(f.sp_cnt, n, np.int32).copy().astype(np.int64),
            )
        finally:
            self._lib.pp_free_fold(fv)

    def chunks(self, contig_name: str, tile_p: int, e_sub: int,
               n_threads: int = 0, num_positions: Optional[int] = None):
        """Compact chunks for one contig: (chunk_pos uint8 (C*e_sub,
        128), chunk_vocab uint8 likewise [255 = pad], chunk_tile int32
        (C,), n_tiles) — the uint8 input layout of the chunk vote
        kernel.  None when tile_p > 256.  num_positions may exceed the
        contig length (position-axis padding: every tile still gets at
        least one chunk)."""
        if tile_p > 256:
            return None
        cid = self.contig_names.index(contig_name)
        P = num_positions if num_positions is not None \
            else self.contig_lens[contig_name]
        cv = self._lib.pp_chunks_from_runs(
            self._view, cid, P, tile_p, e_sub, n_threads
        )
        try:
            c = cv.contents
            if int(c.n_tiles) == 0:
                return None
            n_chunks = int(c.n_chunks)
            e_b = e_sub * 128
            chunk_pos = _as_np(
                c.chunk_pos, n_chunks * e_b, np.uint8
            ).copy().reshape(n_chunks * e_sub, 128)
            chunk_vocab = _as_np(
                c.chunk_vocab, n_chunks * e_b, np.uint8
            ).copy().reshape(n_chunks * e_sub, 128)
            chunk_tile = _as_np(c.chunk_tile, n_chunks, np.int32).copy()
            return chunk_pos, chunk_vocab, chunk_tile, int(c.n_tiles)
        finally:
            self._lib.pp_free_chunks2(cv)

    def lanes(self, contig_name: str, r_sub: int, tile_w: int,
              n_threads: Optional[int] = None,
              num_positions: Optional[int] = None,
              packed4: bool = False,
              cap: bool = False,
              w_lo: int = 0):
        """Lane-aligned pack for the lanes vote kernel
        (ops/vote_lanes.py): returns a LanesPack exposing zero-copy
        (vb (n_blocks*r_sub, tile_w) uint8, block_tile int32
        (n_blocks,), n_tiles) — one vocab byte per event at column
        pos%tile_w, pad byte 255 — or None on bad arguments or a failed
        allocation.  The arrays alias native memory and stay valid only
        until the pack is closed.  num_positions may exceed the contig
        length (position-axis padding).  cap=True uses the
        depth-stratified layout; the pack then carries .ov_pos/.ov_vid
        overflow events the consumer must add onto the kernel counts."""
        from polypolish_tpu_torch.native import binding

        cid = self.contig_names.index(contig_name)
        P = num_positions if num_positions is not None \
            else self.contig_lens[contig_name]
        if n_threads is None:
            n_threads = binding.default_threads()
        lv = self._lib.pp_lanes_from_runs(
            self._view, cid, P, r_sub, tile_w, n_threads,
            1 if packed4 else 0, 1 if cap else 0, int(w_lo),
        )
        c = lv.contents
        if int(c.n_tiles) == 0 or not c.vb:
            self._lib.pp_free_lanes(lv)
            return None
        return LanesPack(self._lib, lv, r_sub, tile_w, packed4=packed4)

    def lanes_mesh(self, contig_name: str, n_data: int, n_pos: int,
                   r_sub: int, tile_w: int, n_threads: int = 0,
                   num_positions: Optional[int] = None,
                   packed4: bool = False):
        """One-call lane packs for every cell of a (data, pos) grid
        (pp_lanes_mesh): position shards of p_shard positions (a
        multiple of tile_w), runs split round-robin over the data axis,
        no row cap, every shard padded to one block count B.  Returns
        (vb (D, S, B*r_sub, tile_w) uint8 copy, or packed4 int32
        (D, S, B*r_sub//4, tile_w), block_tile (D, S, B) int32 copy,
        p_shard, n_tiles), or None on bad arguments or a failed
        allocation."""
        cid = self.contig_names.index(contig_name)
        P = num_positions if num_positions is not None \
            else self.contig_lens[contig_name]
        mv = self._lib.pp_lanes_mesh(
            self._view, cid, P, r_sub, tile_w, n_data, n_pos, n_threads,
            1 if packed4 else 0,
        )
        try:
            c = mv.contents
            if int(c.n_tiles) == 0 or not c.vb:
                return None
            B = int(c.n_blocks)
            vb = _as_np(
                c.vb, n_data * n_pos * B * r_sub * tile_w, np.uint8
            ).copy()
            if packed4:
                vb = vb.view(np.int32).reshape(
                    n_data, n_pos, B * (r_sub // 4), tile_w
                )
            else:
                vb = vb.reshape(n_data, n_pos, B * r_sub, tile_w)
            bt = _as_np(
                c.block_tile, n_data * n_pos * B, np.int32
            ).copy().reshape(n_data, n_pos, B)
            return vb, bt, int(c.p_shard), int(c.n_tiles)
        finally:
            self._lib.pp_free_lanes_mesh(mv)

    # -- raw access ----------------------------------------------------
    def raw(self):
        """Zero-copy numpy views of the run arrays (valid until close):
        (run_contig, run_start, run_len, run_k, vocab_bytes, ov_idx,
        ov_vid, run_poff).  vocab_bytes is the PHYSICAL buffer: a run's
        bytes live at run_poff[r] : run_poff[r]+run_len[r], and two runs
        may share one range (zero-copy '*'-secondary reuse); ov_idx
        holds physical byte indices."""
        v = self._view.contents
        return (
            _as_np(v.run_contig, v.n_runs, np.int32),
            _as_np(v.run_start, v.n_runs, np.int32),
            _as_np(v.run_len, v.n_runs, np.int32),
            _as_np(v.run_k, v.n_runs, np.int32),
            _as_np(v.vocab_bytes, v.n_events, np.uint8),
            _as_np(v.ov_idx, v.n_overflow, np.int64),
            _as_np(v.ov_vid, v.n_overflow, np.int32),
            _as_np(v.run_poff, v.n_runs, np.int64),
        )

    def events(self, contig_name: Optional[str] = None):
        """Expand runs to (pos i64, vid i32, weight f64) event arrays in
        stream order (optionally one contig's): the input of the
        event-stream packers (vote_chunks.prepare_chunks,
        vote_lanes.prepare_lanes)."""
        rc, rs, rl, rk, vb, ov_i, ov_v, poff = self.raw()
        vbid = vb.astype(np.int32)
        if ov_i.size:
            vbid[ov_i] = ov_v
        # logical event -> run index, then gather through the physical
        # per-run offsets (shared ranges gather the same bytes)
        ends = np.cumsum(rl.astype(np.int64))
        starts = ends - rl
        run_of = np.repeat(np.arange(rc.size, dtype=np.int64), rl)
        in_run = np.arange(run_of.size, dtype=np.int64) - starts[run_of]
        vid = vbid[poff[run_of] + in_run]
        pos = rs.astype(np.int64)[run_of] + in_run
        weight = (1.0 / rk.astype(np.float64))[run_of]
        if contig_name is None:
            return pos, vid, weight
        cid = self.contig_names.index(contig_name)
        mask = rc[run_of] == cid
        return pos[mask], vid[mask], weight[mask]


def parse_runs(
    filenames: Sequence[str],
    contig_names: List[str],
    contig_lens: Dict[str, int],
    vocab: Vocab,
    max_errors: int,
    careful: bool,
    n_threads: Optional[int] = None,
    proc_idx: int = 0,
    n_procs: int = 1,
) -> ParsedRuns:
    """Parse SAM files into a ParsedRuns; interns new vocab strings into
    ``vocab`` (ids line up with the native side); fatals mirror the
    reference (alignment.rs:214-272).

    Pod mode (n_procs > 1): parse only byte range ``proc_idx`` of
    ``n_procs`` of every file (read-group snapped; the same boundary
    arithmetic in every shard makes the ranges disjoint and complete),
    and leave the whole-file "no alignments" fatal to the merge."""
    from polypolish_tpu_torch.native import binding

    lib = binding.load_library()
    if n_threads is None:
        n_threads = binding.default_threads()

    files_blob = "\n".join(filenames).encode("utf-8")
    names_blob = "\n".join(contig_names).encode("utf-8")
    lens = np.asarray([contig_lens[n] for n in contig_names], dtype=np.int64)
    vocab_blob = "\n".join(
        binding._transfer_safe(s) for s in vocab.strings
    ).encode("latin-1")

    base_vocab_len = len(vocab.strings)
    view = lib.pp_parse_runs(
        files_blob, len(filenames), names_blob,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(contig_names), vocab_blob, base_vocab_len,
        max_errors, 1 if careful else 0, n_threads, proc_idx, n_procs,
    )
    v = view.contents
    if v.status != 0:
        err = v.error.decode("utf-8", errors="replace")
        lib.pp_free_runs(view)
        quit_with_error(err)
    if v.n_new_vocab > 0:
        blob = ctypes.string_at(
            ctypes.cast(v.new_vocab, ctypes.c_void_p), v.new_vocab_len
        ).decode("latin-1")
        base = len(vocab.strings)
        for i, s in enumerate(blob.split("\n")[: v.n_new_vocab]):
            vid = vocab.intern(s)
            if vid != base + i:
                raise RuntimeError(
                    f"vocab id mismatch for {s!r}: {vid} != {base + i}"
                )
    pr = ParsedRuns(lib, view, contig_names, contig_lens)
    pr.base_vocab_len = base_vocab_len
    return pr


class LanesPack:
    """Owns a PPLanesView (native lane-aligned pack); zero-copy views.
    packed4 packs expose .vb as int32 (n_blocks*r_sub//4, tile_w) —
    the lanes vote kernel's input layout.  Every view aliases native
    memory that close() frees: consumers copy (or upload) first."""

    def __init__(self, lib, view, r_sub: int, tile_w: int,
                 packed4: bool = False):
        self._lib = lib
        self._view = view
        c = view.contents
        self.n_blocks = int(c.n_blocks)
        self.n_tiles = int(c.n_tiles)
        self.n_events = int(c.n_events)
        self.r_sub = r_sub
        self.tile_w = tile_w
        self.packed4 = packed4
        raw = _as_np(c.vb, self.n_blocks * r_sub * tile_w, np.uint8)
        if packed4:
            self.vb = raw.view(np.int32).reshape(
                self.n_blocks * (r_sub // 4), tile_w
            )
        else:
            self.vb = raw.reshape(self.n_blocks * r_sub, tile_w)
        self.block_tile = _as_np(c.block_tile, self.n_blocks, np.int32)
        self.n_overflow = int(c.n_overflow)
        self.ov_pos = _as_np(c.ov_pos, self.n_overflow, np.int32)
        self.ov_vid = _as_np(c.ov_vid, self.n_overflow, np.uint8)

    def close(self) -> None:
        if self._view is not None:
            self.vb = None
            self.block_tile = None
            self.ov_pos = None
            self.ov_vid = None
            self._lib.pp_free_lanes(self._view)
            self._view = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass
