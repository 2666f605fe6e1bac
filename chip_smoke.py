#!/usr/bin/env python3
"""Smoke run of polypolish_tpu_torch (the PyTorch/CUDA port) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and exits non-zero:

1. Print the card (nvidia-smi name, power limit).  Build the native C++
   engine (g++) and the three CUDA kernel sources (one nvcc per source,
   in parallel) from the sources in the checkout, while the workloads are
   generated: benchmarks/workload.py's 4.6 Mb E. coli-shaped draft with
   paired 150 bp reads at 50x (two SAM files), and its repeat-rich
   variant (a 5 kb segment in 8 copies).
2. The lanes vote kernel's three entry points against their plain
   PyTorch version on the card, bitwise: packed4 (A) on the E. coli
   pack, a skewed pack with a tile deeper than 255 byte-rows, and a
   stream rounded to a 32,768-block slab multiple; the byte rows (D/E,
   uint8 and int8) and the packed8 nibbles (C) on the E. coli byte pack
   and the skewed deep pack (past 255 byte-rows and 15 packed8 rows);
   packed8 on tiles of 14, 15, 16, 30 and 31 rows around its 15-row
   flush, and on all-pad and one-value words.  The overflow vote kernel
   (the lanes path's cap-overflow fold) against its plain version,
   bitwise, adding into kernel A's counts: the E. coli overflow list as
   the packer leaves it (phase 3 adds the repeat-rich one), shuffled,
   with dropped and wrapped entries (vid >= 8, pos >= the width, pos in
   [-width, 0)), from views off a 16-byte boundary, one position
   holding 40,000 events of all eight ids, and a list longer than one
   pass of the kernel's grid.
3. The chunk vote kernel against its plain version, bitwise: both pad
   layouts on the E. coli cap-overflow chunks (int32, pos -1) and the
   E. coli events (uint8, vocab 255; it equals kernel A's counts plus
   the overflow kernel's on the E. coli list), tile_p 128/256/512 x e_sub 4/8
   on a 3 M-event skewed stream, two chunks per step at e_sub 4; deep
   skewed tiles (one 300 chunks deep per step, tiles of pad chunks only,
   tiles with no chunk) at tile_p 128/256/512/2048 in both layouts and
   two chunks per step; and the repeat-rich workload's uint8 chunks.
4. End to end: ``polish`` on the card for both workloads with
   backend="device" (kernel_variant "lanes" and "mxu") and backend
   "xla", each FASTA byte-identical to the port's backend="host" run
   and each stderr identical with the clock masked.  The kernels'
   launch counters are zeroed just before each run and read just after:
   lanes launches kernel A and the overflow kernel and no chunk kernel,
   mxu the chunk kernel and no other, xla no hand kernel.  Per-stage
   times are printed.
5. The other entry points at full size, each with the counters zeroed
   before and read after, each result equal to the host fold's counts:
   LanesPolisher with bodies "packed" and "cmp" on the E. coli byte pack
   (entry point lanes_vote_bytes and the overflow kernel; its decisions
   equal the host consensus), dense_counts_lanes(body="packed8",
   cap=True) on all E. coli events (lanes_vote_packed8 and the overflow
   kernel), and dense_counts_chunks with
   fused "split", "fused" and "unfused" plus two chunks per step
   (chunk_vote).
6. Kernel and plain-version times with CUDA events, one PyTorch library
   call on the same inputs as a yardstick (torch.bincount), and the
   least time the card could take (bytes over 3.35 TB/s, or integer
   operations over the int32 issue rate; for the chunk layout the bytes
   are the array that marks pads whole and the other one for the events
   that are not pads).  The chunk vote kernel is
   timed with its wrapper's device work (order check and tile prefix),
   alone, and as a whole ``chunk_counts`` call, on the E. coli pileup,
   the E. coli overflow chunks and the repeat-rich pileup.  The
   overflow fold on the E. coli and repeat-rich overflow lists: the
   overflow kernel alone (its bound: 5 B an event and each distinct
   (pos, vid) word read and written once), with one event (the launch
   floor), as an ``overflow_counts`` call on device arrays and with its
   upload; its plain version (``add_overflow_counts``, the JAX
   package's scatter route), ``index_put_`` alone and ``torch.bincount``
   of vid * width + pos on the same events; and the chunk route that
   the lanes path took before (host ``prepare_chunks``, upload, chunk
   kernel, add), whose counts equal the kernel's; beside phase 4's
   kernel_b stage.
7. Windowed polish of the E. coli workload at 1 Mi windows (five
   windows, POLYPOLISH_TPU_WINDOW_MIN=1).  First kernel A and the
   overflow kernel against their plain versions, bitwise, on the second
   window and the tail window at the shapes the device twin gives them
   (pack and overflow list from the window origin), their sum equal to
   the host fold of the window.  Then the device twin with
   POLYPOLISH_TPU_WINDOW_DEPTH 1, 2, 3, 2 and 1 (accepted, no effect:
   the windows run in turn) and the host twin, each FASTA and stderr
   equal to the unwindowed host run of phase 4; kernel A launched once
   per window and the overflow kernel once per window with cap-overflow
   events, no chunk kernel.  Wall times with no synchronising timer, and
   the stage split (per window) with one.
8. One 33.6 Mb contig (benchmarks/workload.py, paired 150 bp reads at
   50x) at the default window settings: 8 Mb windows (four full ones
   and a tail).  The kernels against their plain versions and the host
   window fold on the second and the tail window as in phase 7, then
   the device twin against the host twin, with the per-window stage
   times and the device twin's peak device memory (reset before it).
9. ``filter`` on the E. coli, repeat-rich and repeats16 (a 5 kb segment
   in 16 copies) workloads, each against the same run with the grid
   threshold raised so that numpy decides every verdict (output SAMs
   byte-identical, counts and stderr equal); the device grid step must
   run on every file whose pair grid reaches 1 M entries, and repeats16
   must reach it in both files.  Then ``full`` on the E. coli workload
   against ``filter`` followed by a host-backend ``polish``.
10. The event-stream path of the pure-Python reader.  At full size: the
   E. coli contig's event stream (ParsedRuns.events(), 226 M events)
   filled into its ContigVotes, then polish_sequences with no runs
   handle on backend "device" (PolisherModel.pack, then the chunk
   kernel on the whole pileup): FASTA and stderr equal to phase 4's
   host run, one chunk-kernel launch and no lanes launch; stage times
   and the host's peak RSS.  At a cut genome (100 kb of the same
   shape): ``polish --pure-python`` with --backend host, device and
   xla, from the two SAMs and from the same records as BGZF BAM
   (written here), six FASTAs byte-identical to the native host run.
11. ``batch --backend device`` over a six-job manifest (ecoli50x,
   repeats and repeats16, each twice) with --workers 1 and 3: every
   output equal to its genome's host FASTA, kernel A launched six
   times and the overflow kernel once per job with cap-overflow events,
   no chunk kernel; then --resume, which skips all six and launches
   nothing.
12. ``--backend auto`` and ``--pod-shards``: the measured link, the
   cost model's prediction for the E. coli SAM bytes, the calibration
   constants as this run measures them (medians of three warm host and
   lanes runs on E. coli); ``polish`` with no --backend
   takes the predicted backend and equals the host FASTA;
   ``polish --pod-shards 4`` on E. coli and repeats equals the host run
   (FASTA, --debug TSV, stderr but for the "Pod mode:" line).
13. The multi-device half on grids of ``cuda:0`` and gloo ranks on it.
   ``polish(backend="sharded")`` on E. coli at grids 1x1 and 2x2 and on
   repeats at 2x1 and 1x2: FASTA and stderr equal to phase 4's host
   run, kernel A launched once per grid cell (the mesh pack, no cap, so
   no overflow kernel), every kernel call held bitwise against its plain
   version (capture_calls); the mesh pack's bytes, its block count,
   stage times and peak device memory; kernel A timed on the 1x1
   E. coli mesh pack.  Then two ranks of ``polish --distributed`` with
   POLYPOLISH_TPU_POD_DEVICE_VOTES=1 on E. coli, both on ``cuda:0``
   over a localhost gloo group: rank 0's FASTA and stderr (but for the
   "Pod mode:" line and gloo's lines) equal the host run, rank 1's
   stdout is empty, each rank reports kernel A once and the overflow
   kernel once if its pack had cap-overflow events, and leaves its
   group.  Last, two ranks of ``batch --shard-across-hosts --backend
   device`` over phase 11's six jobs: three each, every output equal to
   its genome's host FASTA.

Then the ``kernels`` JSON line and, last, the device JSON line.

Exits non-zero, printing no result, when torch.cuda.is_available() is
false or the repository's port package is not importable.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# int32 add/logic issue rate of the H100 SXM's CUDA cores: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost (Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "build", "chip_smoke")
TIMED_LAUNCHES = 50


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the int32 issue rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


_CLOCK = re.compile(r"\(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\)|"
                    r"Time to run: \d+:\d\d:\d\d\.\d{6}")


def generate_workloads():
    """Both workloads on disk under build/chip_smoke/: {name: (fasta,
    [sam1, sam2])}."""
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    import workload

    cases = {}
    for name, kwargs in (("ecoli50x", {}),
                         ("repeats", dict(repeat_len=5000,
                                          repeat_copies=8))):
        fasta, sams, _info = workload.make_paired_case(seed=0, **kwargs)
        cases[name] = workload.write_case(DATA_DIR, name, fasta, sams)
        del fasta, sams
    return cases


def build_everything(cases_future_fn):
    """Native engine + CUDA kernels built while the workloads are
    generated; returns (cases, seconds per build)."""
    from polypolish_tpu_torch import _build
    from polypolish_tpu_torch.native import binding

    def native():
        t0 = time.monotonic()
        binding.load_library()
        return time.monotonic() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        f_native = pool.submit(native)
        f_cuda = pool.submit(_build.build_all)
        cases = cases_future_fn()
        seconds = {"sam_packer.cc (g++)": f_native.result()}
        seconds.update({f"{k}.cu (nvcc)": v
                        for k, v in f_cuda.result().items()})
    return cases, seconds


def parse(fasta, sams):
    """(ParsedRuns, contig name, length, sequence, vocab) of a
    single-contig workload."""
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.vocab import Vocab

    fa = load_fasta(fasta)
    names = [n for n, _, _ in fa]
    lens = {n: len(s) for n, _, s in fa}
    vocab = Vocab()
    pr = runs.parse_runs(sams, names, lens, vocab, 10, False)
    return pr, names[0], lens[names[0]], fa[0][2], vocab


def lanes_keys(vb: torch.Tensor, block_tile: torch.Tensor, n_tiles: int,
               r_sub: int, tile_w: int, body: str) -> torch.Tensor:
    """Flattened (v * width + position) keys of every dense slot of a
    lane pack in the body's layout — the input of the torch.bincount
    yardstick."""
    from polypolish_tpu_torch.ops import vote_lanes

    width = n_tiles * tile_w
    rpb = vote_lanes._rows_per_block(r_sub, body)
    rows = block_tile.to(torch.int64).repeat_interleave(rpb) * tile_w
    cols = torch.arange(tile_w, device=vb.device)
    parts = []
    step = (1 << 22) // tile_w
    for r0 in range(0, vb.shape[0], step):
        b = vote_lanes._slots(vb[r0:r0 + step], body)
        slot = rows[r0:r0 + step, None] + cols[None, :]
        keys = b.to(torch.int64) * width + slot[:, :, None]
        parts.append(keys[b < 8])
    return torch.cat(parts)


def chunk_keys(cp, cv, ct, n_tiles, tile_p=256):
    width = n_tiles * tile_p
    pos = cp.reshape(ct.shape[0], -1).to(torch.int64)
    voc = cv.reshape(ct.shape[0], -1).to(torch.int64)
    keep = (pos >= 0) & (pos < tile_p) & (voc >= 0) & (voc < 8)
    return (voc * width + ct.to(torch.int64)[:, None] * tile_p + pos)[keep]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from polypolish_tpu_torch.models.polisher import LanesPolisher
    from polypolish_tpu_torch.native import binding
    from polypolish_tpu_torch.ops import vote_chunks, vote_lanes
    from polypolish_tpu_torch.pipeline.polish import (
        _orig_ids_for_seq,
        _pad_bucket,
        polish,
    )
    from polypolish_tpu_torch.utils.profiling import StageTimer

    t_start = time.monotonic()
    dev = torch.device("cuda")
    torch.cuda.init()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # -- phase 1: builds + workloads ----------------------------------
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    t0 = time.monotonic()
    cases, build_s = build_everything(generate_workloads)
    for k, v in build_s.items():
        print(f"build {k}: {v:.1f} s")
    from polypolish_tpu_torch import _build

    for name in _build.sources():
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
            # the lanes kernels keep their planes and counts in registers
            check(name != "lanes_vote" or "spill" not in line
                  or " 0 bytes spill stores, 0 bytes spill loads" in line,
                  f"ptxas {name}: {line.strip()}")
    print(f"phase 1 (builds + workloads): {time.monotonic() - t0:.1f} s")

    R_SUB, TILE_W = vote_lanes.R_SUB, vote_lanes.TILE_W
    LANES = ("lanes_vote_packed4", "lanes_vote_bytes", "lanes_vote_packed8")
    KERNELS = LANES + ("chunk_vote", "overflow_vote")
    errs = {k: 0 for k in KERNELS}

    # -- phase 2: lanes vote kernel vs plain --------------------------
    t0 = time.monotonic()
    fasta, sams = cases["ecoli50x"]
    pr, name, P, seq, vocab = parse(fasta, sams)
    p_pad = _pad_bucket(P)
    pack = pr.lanes(name, R_SUB, TILE_W, num_positions=p_pad, packed4=True,
                    cap=True)
    check(pack is not None, "E. coli lane pack")
    try:
        # copies: the pack's arrays alias native memory that close() frees
        e_vb = torch.from_numpy(pack.vb).to(dev, copy=True)
        e_bt = torch.from_numpy(pack.block_tile).to(dev, copy=True)
        e_bt_host = pack.block_tile.copy()
        e_ntiles = pack.n_tiles
        ov_pos = pack.ov_pos.astype(np.int64)
        ov_vid = pack.ov_vid.astype(np.int32)
        e_ov = (pack.ov_pos.copy(), pack.ov_vid.copy())  # int32, uint8
        print(f"E. coli pack: P={P} p_pad={p_pad} n_blocks={pack.n_blocks} "
              f"vb={pack.vb.nbytes} B events={pack.n_events} "
              f"overflow={pack.n_overflow}")
    finally:
        pack.close()
    bpack = pr.lanes(name, R_SUB, TILE_W, num_positions=p_pad, cap=True)
    check(bpack is not None, "E. coli byte pack")
    try:
        h_vb8 = bpack.vb.copy()  # uint8 byte rows, the D/E and C source
        h_bt8 = bpack.block_tile.copy()
        b_ov = (bpack.ov_pos.copy(), bpack.ov_vid.copy())
    finally:
        bpack.close()
    b_vb = torch.from_numpy(h_vb8).to(dev)
    b_bt = torch.from_numpy(h_bt8).to(dev)
    n_vb = torch.from_numpy(vote_lanes.to_packed8(h_vb8, R_SUB)).to(dev)

    def check_lanes(label, vb, bt, n_tiles, r_sub, tile_w, body="packed4",
                    **kwargs):
        entry = vote_lanes.BODIES[body][1]
        got = vote_lanes.lanes_counts(vb, bt, n_tiles, r_sub, tile_w, body,
                                      **kwargs)
        want = vote_lanes.lanes_counts_plain(vb, bt, n_tiles, r_sub, tile_w,
                                             body)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"{entry} != plain on {label} (max err {err})")
        errs[entry] = max(errs[entry], err)
        print(f"{entry} == plain on {label}: {tuple(vb.shape)} {vb.dtype}, "
              f"{n_tiles} tiles, {int(want.sum())} votes")
        return got

    pack_bytes = e_vb.numel() * e_vb.element_size()
    e_counts = check_lanes("E. coli pack", e_vb, e_bt, e_ntiles, R_SUB,
                           TILE_W)
    # the padded capped pack: 512 all-pad blocks (4,096 int32 rows) on
    # the last tile, the pad a capped count of 4,609 blocks rounds to
    # (geom_pad(4,609) = 5,120)
    n_pad = vote_lanes.geom_pad(4609) - 4609 + 1
    check(n_pad == 512, f"padded pack: {n_pad} pad blocks")
    pad_vb = torch.cat([e_vb, torch.full((n_pad * R_SUB // 4, TILE_W), -1,
                                         dtype=torch.int32, device=dev)])
    pad_bt = torch.cat([e_bt, torch.full((n_pad,), e_ntiles - 1,
                                         dtype=torch.int32, device=dev)])
    got = check_lanes(f"padded E. coli pack (+{n_pad} pad blocks on the "
                      f"last tile)", pad_vb, pad_bt, e_ntiles, R_SUB, TILE_W)
    check(torch.equal(got, e_counts), "padded pack counts != capped pack")
    for body, vb in (("packed", b_vb), ("cmp", b_vb.view(torch.int8)),
                     ("packed8", n_vb)):
        got = check_lanes(f"E. coli pack, body {body}", vb, b_bt, e_ntiles,
                          R_SUB, TILE_W, body)
        check(torch.equal(got, e_counts),
              f"body {body} counts != packed4 counts on the E. coli pack")
    del got

    # skewed pack: a hot spot ~2,000 deep puts one tile far past 255
    # byte-rows and 31 packed8 rows (the kernels' plane-flush periods)
    rng = np.random.default_rng(1)
    n_sk, p_sk = 3_000_000, 200_000
    pos = np.concatenate([rng.integers(0, p_sk, n_sk - 40_000),
                          rng.integers(5000, 5020, 40_000)])
    voc = rng.integers(0, 8, pos.size)
    voc[rng.random(pos.size) < 0.02] = 200  # sparse tier -> pad byte
    vb_u8, bt, n_tiles = vote_lanes.prepare_lanes(pos, voc, p_sk)
    deepest = int((bt == 5000 // TILE_W).sum()) * R_SUB
    check(deepest > 255, f"skewed pack deepest tile {deepest} byte-rows")
    d_bt = torch.from_numpy(bt).to(dev)
    for body, arr in (("packed4", vote_lanes.to_packed4(vb_u8, R_SUB)),
                      ("packed", vb_u8),
                      ("packed8", vote_lanes.to_packed8(vb_u8, R_SUB))):
        check_lanes(f"skewed pack, body {body} (deepest tile {deepest} "
                    f"byte-rows)", torch.from_numpy(arr).to(dev), d_bt,
                    n_tiles, R_SUB, TILE_W, body)

    # packed8 around the bit-sliced kernel's 15-row flush: tiles of
    # 0/14/15/16/30/31/400 int32 rows of random nibbles, then all-pad
    # words and words of one value in all eight nibbles
    per_tile = [0, 14, 15, 16, 30, 31, 400, 1]
    bt = np.repeat(np.arange(len(per_tile), dtype=np.int32), per_tile)
    words = np.zeros((bt.size, TILE_W), np.uint32)
    for k in range(8):
        words |= rng.integers(0, 16, words.shape).astype(np.uint32) << (4 * k)
    check_lanes("packed8 flush boundaries (tiles of 0-400 rows)",
                torch.from_numpy(words.view(np.int32)).to(dev),
                torch.from_numpy(bt).to(dev), len(per_tile), 8, TILE_W,
                "packed8")
    values = [15, 0, 7, 3, 8]
    words = np.repeat(np.array([int(f"{v:x}" * 8, 16) for v in values],
                               np.uint32), 16)[:, None].repeat(TILE_W, 1)
    bt = np.repeat(np.arange(len(values), dtype=np.int32), 16)
    got = check_lanes("packed8 all-pad and one-value words",
                      torch.from_numpy(words.view(np.int32)).to(dev),
                      torch.from_numpy(bt).to(dev), len(values), 8, TILE_W,
                      "packed8")
    per_value = got.view(8, len(values), TILE_W).sum(dim=2).cpu().numpy()
    check(per_value[:, 0].sum() == 0 and per_value[:, 4].sum() == 0
          and all(per_value[v, t] == 8 * 16 * TILE_W
                  for t, v in ((1, 0), (2, 7), (3, 3))),
          f"packed8 one-value words counted {per_value.T.tolist()}")

    # slab-rounded stream: 33,000 real blocks rounded up to 65,536 (two
    # slabs of MAX_BLOCKS_PER_CALL), pad blocks on the last tile
    sl_tile_w, sl_tiles = 128, 4000
    per_tile = rng.integers(1, 16, sl_tiles)
    per_tile[-1] += 33_000 - per_tile.sum()
    bt = np.repeat(np.arange(sl_tiles, dtype=np.int32), per_tile)
    n_blocks = vote_lanes.geom_pad(bt.size,
                                   slab=vote_lanes.MAX_BLOCKS_PER_CALL)
    check(n_blocks == 2 * vote_lanes.MAX_BLOCKS_PER_CALL,
          f"slab rounding gave {n_blocks} blocks")
    bt = np.concatenate([bt, np.full(n_blocks - bt.size, sl_tiles - 1,
                                     np.int32)])
    bytes_ = rng.integers(0, 11, (n_blocks * R_SUB // 4, sl_tile_w, 4),
                          dtype=np.uint8)
    bytes_[bytes_ >= 8] = 255  # pad / sparse slots
    check_lanes(f"slab-rounded stream ({n_blocks} blocks)",
                torch.from_numpy(bytes_.view(np.int32)[..., 0]).to(dev),
                torch.from_numpy(bt).to(dev), sl_tiles, R_SUB, sl_tile_w)
    del bytes_

    # the overflow vote kernel against its plain version, adding into
    # kernel A's counts of the E. coli pack: the list as the packer
    # leaves it, shuffled, with dropped and wrapped entries, and from
    # views off a 16-byte boundary; one deep position; a list longer than
    # one pass of the kernel's grid; an empty list launches nothing
    e_width = e_ntiles * TILE_W
    d_eop, d_eov = (torch.from_numpy(a).to(dev) for a in e_ov)
    e_full = check_overflow(errs, "E. coli overflow list (as packed)",
                            e_counts, d_eop, d_eov)
    check(int((e_full - e_counts).sum()) == int((e_ov[1] < 8).sum()),
          "E. coli overflow list: votes lost")
    perm = torch.from_numpy(rng.permutation(e_ov[0].size)).to(dev)
    got = check_overflow(errs, "E. coli overflow list shuffled", e_counts,
                         d_eop[perm], d_eov[perm])
    check(torch.equal(got, e_full), "shuffled list != sorted list")
    extra = np.array([[e_width, 1], [e_width + 7, 2], [2**31 - 1, 3],
                      [-1, 4], [-e_width, 5], [-e_width - 1, 6], [5, 8],
                      [7, 255]], np.int64)
    got = check_overflow(
        errs, "E. coli overflow list with vid >= 8, pos >= width and "
        "pos < 0", e_counts,
        torch.cat([d_eop, torch.from_numpy(extra[:, 0].astype(np.int32))
                   .to(dev)]),
        torch.cat([d_eov, torch.from_numpy(extra[:, 1].astype(np.uint8))
                   .to(dev)]))
    wrapped = (got - e_full).cpu()
    check(int(wrapped.sum()) == 2 and int(wrapped[4, e_width - 1]) == 1
          and int(wrapped[5, 0]) == 1,
          "dropped or wrapped overflow entries counted wrong")
    got = check_overflow(
        errs, "E. coli overflow list from views off a 16-byte boundary",
        e_counts,
        torch.cat([d_eop[:3], d_eop])[3:], torch.cat([d_eov[:3], d_eov])[3:])
    check(torch.equal(got, e_full), "unaligned views != aligned list")
    hot = e_width // 2 + 5
    deep_pos = np.concatenate([np.arange(hot - 600, hot, 3),
                               np.full(40_000, hot),
                               np.arange(hot + 1, hot + 601, 3)])
    deep_vid = np.concatenate([rng.integers(0, 8, 200),
                               np.repeat(np.arange(8), 5000),
                               rng.integers(0, 8, 200)])
    got = check_overflow(errs, "one position 40,000 events deep", e_counts,
                         *(torch.from_numpy(a).to(dev) for a in (
                             deep_pos.astype(np.int32),
                             deep_vid.astype(np.uint8))))
    check(((got - e_counts)[:, hot] == 5000).all().item(),
          "deep position counted wrong")
    n_grid = vote_lanes._overflow_kernel().overflow_vote_grid_events()
    long_pos = np.sort(rng.integers(0, e_width, n_grid + 12_345)
                       ).astype(np.int32)
    check_overflow(errs, f"{long_pos.size} events (one pass of the grid "
                   f"is {n_grid})", e_counts,
                   *(torch.from_numpy(a).to(dev) for a in (
                       long_pos, rng.integers(0, 8, long_pos.size)
                       .astype(np.uint8))))
    before = vote_lanes.overflow_counts.launches
    got = vote_lanes.overflow_counts(e_counts.clone(), d_eop[:0], d_eov[:0])
    check(torch.equal(got, e_counts)
          and vote_lanes.overflow_counts.launches == before,
          "an empty overflow list changed the counts or launched")
    del got, wrapped, perm, long_pos
    print(f"phase 2 (lanes and overflow kernels): "
          f"{time.monotonic() - t0:.1f} s")

    # -- phase 3: chunk vote kernel vs plain --------------------------
    t0 = time.monotonic()

    def check_chunks(label, cp, cv, ct, n_tiles, tile_p=256, e_sub=8,
                     k=1):
        got = vote_chunks.chunk_counts(cp, cv, ct, n_tiles, tile_p, e_sub,
                                       chunks_per_step=k)
        want = vote_chunks.chunk_counts_plain(cp, cv, ct, n_tiles, tile_p,
                                              e_sub)
        _, plan = vote_chunks.chunk_vote_launch(cp, cv, ct, n_tiles, tile_p,
                                                e_sub)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"chunk kernel != plain on {label} (max err {err})")
        check(torch.equal(plan[:n_tiles + 1],
                          vote_chunks.tile_chunk_start(ct, n_tiles))
              and int(plan[n_tiles + 1]) == 0,
              f"chunk kernel's tile prefix != plain on {label}")
        errs["chunk_vote"] = max(errs["chunk_vote"], err)
        print(f"chunk_vote == plain on {label}: {ct.shape[0]} chunks "
              f"{cp.dtype}, {int(want.sum())} votes")
        return got

    cp, cv, ct, ov_tiles = vote_chunks.prepare_chunks(ov_pos, ov_vid, p_pad)
    o_cp, o_cv, o_ct = (torch.from_numpy(a).to(dev) for a in (cp, cv, ct))
    check_chunks("E. coli overflow chunks (int32, pad pos -1)", o_cp, o_cv,
                 o_ct, ov_tiles)
    u8 = pr.chunks(name, vote_chunks.TILE_P, vote_chunks.E_SUB,
                   num_positions=p_pad)
    check(u8 is not None, "uint8 chunks")
    u_cp, u_cv, u_ct = (torch.from_numpy(a).to(dev) for a in u8[:3])
    u_tiles = u8[3]
    u_counts = check_chunks("E. coli events (uint8, pad vocab 255)",
                            u_cp, u_cv, u_ct, u_tiles)
    # both layouts add up to the same pileup: kernel A's counts plus the
    # overflow kernel's fold of the list == the chunks' counts
    check(torch.equal(e_full, u_counts[:, :p_pad]),
          "lanes + overflow counts != uint8 chunk counts")
    del u8, u_counts, e_full

    # tile_p / e_sub / chunks_per_step geometry on a skewed stream
    pos = np.concatenate([rng.integers(0, p_sk, n_sk - 200_000),
                          rng.integers(7000, 7100, 200_000)])
    voc = rng.integers(0, 10, pos.size)
    for tile_p in (128, 256, 512):
        for e_sub in (4, 8):
            k = 2 if e_sub == 4 else 1
            cp, cv, ct, n_t = vote_chunks.prepare_chunks(
                pos, voc, p_sk, tile_p, e_sub, chunk_multiple=k)
            check_chunks(f"skewed stream tile_p={tile_p} e_sub={e_sub} "
                         f"chunks_per_step={k}",
                         *(torch.from_numpy(a).to(dev) for a in (cp, cv, ct)),
                         n_t, tile_p, e_sub, k)

    # one CTA per tile: a tile 300 chunks deep, tiles of pad chunks only
    # and tiles with no chunk (written as zeros, never zero-filled)
    for tile_p, e_sub, k, layout in ((128, 8, 1, "int32"),
                                     (128, 4, 2, "uint8"),
                                     (256, 8, 1, "uint8"),
                                     (256, 8, 2, "int32"),
                                     (512, 2, 1, "int32"),
                                     (2048, 8, 1, "int32")):
        n_t = 60
        per_tile = rng.integers(1, 5, n_t) * k
        per_tile[3] = 300 * k
        per_tile[20:22] = 0
        ct = np.repeat(np.arange(n_t, dtype=np.int32), per_tile)
        e = e_sub * 128
        cp = rng.integers(0, tile_p, (ct.size, e))
        cv = rng.integers(0, 10, (ct.size, e))
        pad = (rng.random(cp.shape) < 0.1) | ((ct >= 10) & (ct < 15))[:, None]
        if layout == "uint8":
            cp = cp.astype(np.uint8)
            cv = np.where(pad, 255, cv).astype(np.uint8)
        else:
            cp = np.where(pad, -1, cp).astype(np.int32)
            cv = cv.astype(np.int32)
        got = check_chunks(f"deep skewed tiles tile_p={tile_p} e_sub={e_sub} "
                           f"chunks_per_step={k} {layout}",
                           *(torch.from_numpy(a.reshape(-1, 128)).to(dev)
                             for a in (cp, cv)),
                           torch.from_numpy(ct).to(dev), n_t, tile_p, e_sub, k)
        by_tile = got.view(8, n_t, tile_p).sum(dim=(0, 2)).cpu().numpy()
        check((by_tile[10:15] == 0).all() and (by_tile[20:22] == 0).all(),
              "pad-only or chunk-less tiles counted votes")

    # the repeat-rich workload's uint8 chunks: its deepest tiles
    r_pr, r_name, r_P, _, _ = parse(*cases["repeats"])
    r8 = r_pr.chunks(r_name, vote_chunks.TILE_P, vote_chunks.E_SUB,
                     num_positions=_pad_bucket(r_P))
    check(r8 is not None, "repeats uint8 chunks")
    r_cp, r_cv, r_ct = (torch.from_numpy(a).to(dev) for a in r8[:3])
    r_tiles = r8[3]
    r_deepest = int(np.bincount(r8[2]).max())
    del r8
    r_pack = r_pr.lanes(r_name, R_SUB, TILE_W, num_positions=_pad_bucket(r_P),
                        packed4=True, cap=True)
    check(r_pack is not None, "repeats lane pack")
    try:  # the repeats overflow list, for phase 6's timings
        r_ov = (r_pack.ov_pos.copy(), r_pack.ov_vid.copy())
        r_ntiles = r_pack.n_tiles
    finally:
        r_pack.close()
    r_pr.close()
    check_overflow(errs, "repeats overflow list (as packed)",
                   torch.zeros((8, r_ntiles * TILE_W), dtype=torch.int32,
                               device=dev),
                   *(torch.from_numpy(a).to(dev) for a in r_ov))
    check_chunks(f"repeats events (uint8; deepest tile {r_deepest} chunks)",
                 r_cp, r_cv, r_ct, r_tiles)
    print(f"phase 3 (chunk kernel): {time.monotonic() - t0:.1f} s")

    # -- phase 4: end to end ------------------------------------------
    launches = {k: 0 for k in errs}

    def zero_counts():
        vote_lanes.lanes_counts.launches.clear()
        vote_chunks.chunk_counts.launches = 0
        vote_lanes.overflow_counts.launches = 0

    def read_counts():
        got = {k: vote_lanes.lanes_counts.launches[k] for k in LANES}
        got["chunk_vote"] = vote_chunks.chunk_counts.launches
        got["overflow_vote"] = vote_lanes.overflow_counts.launches
        for k, n in got.items():
            launches[k] += n
        return got

    paths = (("host", dict(backend="host")),
             ("lanes", dict(backend="device", kernel_variant="lanes")),
             ("mxu", dict(backend="device", kernel_variant="mxu")),
             ("xla", dict(backend="xla")))
    host_runs = {}
    kernel_b_stage = {}
    for case, (fasta_c, sams_c) in cases.items():
        runs = {}
        for path, kwargs in paths:
            timer = StageTimer(sync_device=dev if path != "host" else None)
            out, err = io.StringIO(), io.StringIO()
            zero_counts()
            t0 = time.monotonic()
            with contextlib.redirect_stderr(err):
                lengths = polish(None, 0.2, 0.5, 10, 5, False, fasta_c,
                                 sams_c, out=out, device=dev, timer=timer,
                                 **kwargs)
            total = time.monotonic() - t0
            counts = read_counts()
            runs[path] = (out.getvalue(), _CLOCK.sub("", err.getvalue()))
            stages = fmt_stages(timer.seconds)
            print(f"e2e {case} path={path}: total {total:.3f} s | {stages} "
                  f"| launches {counts} | lengths {lengths}")
            n_lanes = sum(counts[k] for k in LANES)
            if path == "lanes":
                kernel_b_stage[case] = timer.seconds.get("kernel_b", 0)
                check(counts["lanes_vote_packed4"] > 0
                      and counts["overflow_vote"] > 0
                      and counts["chunk_vote"] == 0,
                      f"{case}: the lanes path must launch kernel A and "
                      f"the overflow kernel, no chunk kernel {counts}")
            elif path == "mxu":
                check(counts["chunk_vote"] > 0 and n_lanes == 0
                      and counts["overflow_vote"] == 0,
                      f"{case}: mxu path must launch chunk_vote and no "
                      f"other kernel {counts}")
            else:
                check(sum(counts.values()) == 0,
                      f"{case}: {path} path launched a hand kernel "
                      f"{counts}")
        for path, _ in paths[1:]:
            check(runs[path][0] == runs["host"][0],
                  f"{case}: {path} FASTA != host FASTA")
            check(runs[path][1] == runs["host"][1],
                  f"{case}: {path} stderr != host stderr")
        host_runs[case] = runs["host"]
        fasta_out = runs["host"][0]
        check(fasta_out.startswith(">") and fasta_out.count("\n") == 2,
              f"{case}: malformed FASTA")
        print(f"e2e {case}: lanes, mxu and xla FASTA == host FASTA "
              f"({len(fasta_out)} bytes), stderr equal")
    print(f"peak device memory {torch.cuda.max_memory_allocated()} B")

    # -- phase 5: the other entry points at full size -----------------
    t0 = time.monotonic()
    host_counts, _, _, thr = pr.fold(name, thresholds=(5, 0.5, 0.2))
    host_counts = torch.from_numpy(host_counts.copy())
    valid_thr, invalid_thr, low = (a.copy() for a in thr)
    orig_id = _orig_ids_for_seq(seq, vocab)
    _, host_status = binding.consensus_dense_native(
        host_counts.numpy(), valid_thr, invalid_thr, low, orig_id)
    host_status = host_status.copy()

    def pad(a, fill, dtype):
        out = np.full(p_pad, fill, dtype=dtype)
        out[:P] = a
        return torch.from_numpy(out).to(dev)

    i32max = np.int32(2**31 - 1)
    thr_args = (pad(valid_thr, i32max, np.int32),
                pad(invalid_thr, i32max, np.int32), pad(low, True, bool),
                pad(orig_id, 0, np.int32))

    def check_path(label, counts, *want_launch):
        got = read_counts()
        check(all(got[k] > 0 for k in want_launch),
              f"{label}: {want_launch} not launched {got}")
        check(torch.equal(counts.cpu(), host_counts),
              f"{label}: counts != host fold counts")
        print(f"path {label}: counts == host fold, launches {got}")

    for body, vb in (("packed", h_vb8), ("cmp", h_vb8.view(np.int8))):
        model = LanesPolisher(p_pad, dev, R_SUB, TILE_W, body=body)
        zero_counts()
        counts, _, status = model.forward_pack(vb, h_bt8, *thr_args,
                                               ov_pos=b_ov[0],
                                               ov_vid=b_ov[1])
        check(np.array_equal(status[:P].cpu().numpy(), host_status),
              f"LanesPolisher body {body}: status != host consensus")
        check_path(f"LanesPolisher(body={body!r}).forward_pack",
                   counts[:, :P], "lanes_vote_bytes", "overflow_vote")
    del h_vb8, model, counts, status

    ev_pos, ev_vid, _ = pr.events(name)
    print(f"E. coli events: {ev_pos.size}")
    zero_counts()
    counts = vote_lanes.dense_counts_lanes(ev_pos, ev_vid, P,
                                           body="packed8", cap=True,
                                           device=dev)
    check_path("dense_counts_lanes(body='packed8', cap=True)", counts,
               "lanes_vote_packed8", "overflow_vote")
    for fused, k in (("split", 1), ("fused", 1), ("unfused", 1),
                     ("unfused", 2)):
        zero_counts()
        counts = vote_chunks.dense_counts_chunks(ev_pos, ev_vid, P,
                                                 fused=fused,
                                                 chunks_per_step=k,
                                                 device=dev)
        check_path(f"dense_counts_chunks(fused={fused!r}, "
                   f"chunks_per_step={k})", counts, "chunk_vote")
    del ev_pos, ev_vid, counts
    pr.close()
    print(f"phase 5 (entry points): {time.monotonic() - t0:.1f} s")

    # -- phase 6: timings ---------------------------------------------
    stream = torch.cuda.current_stream().cuda_stream
    lib_l = vote_lanes._kernel()
    width = 8 * e_ntiles * TILE_W
    out_l = torch.empty_like(e_counts)

    def lanes_timing(entry, body, vb, bt):
        rpb = vote_lanes._rows_per_block(R_SUB, body)
        starts = torch.from_numpy(vote_lanes.tile_row_start(
            bt.cpu().numpy(), e_ntiles, rpb)).to(dev)
        fn = getattr(lib_l, entry)

        def run():
            check(fn(vb.data_ptr(), starts.data_ptr(), out_l.data_ptr(),
                     e_ntiles, TILE_W, stream) == 0, f"{entry} launch")

        ms = cuda_ms(run, TIMED_LAUNCHES)
        plain = cuda_ms(lambda: vote_lanes.lanes_counts_plain(
            vb, bt, e_ntiles, R_SUB, TILE_W, body), 3)
        keys = lanes_keys(vb, bt, e_ntiles, R_SUB, TILE_W, body)
        lib = cuda_ms(lambda: torch.bincount(keys, minlength=width), 3)
        votes = int(keys.numel())
        n_bytes = (vb.numel() * vb.element_size() + bt.numel() * 4
                   + width * 4)
        return ms, plain, lib, votes, n_bytes

    chunk_extra = {}

    def chunk_timing(label, cp, cv, ct, n_tiles):
        # the launch's device work (tile prefix, per-tile CTAs, deep-tile
        # segments), then the whole chunk_counts call, whose host read of
        # the order flag waits for the device after each launch
        ms = cuda_ms(lambda: vote_chunks.chunk_vote_launch(cp, cv, ct,
                                                           n_tiles),
                     TIMED_LAUNCHES)
        per_tile = torch.bincount(ct.to(torch.int64), minlength=n_tiles)
        chunk_extra[label] = {
            "wrapper_ms": cuda_ms(lambda: vote_chunks.chunk_counts(
                cp, cv, ct, n_tiles), TIMED_LAUNCHES),
            "deepest_tile_chunks": int(per_tile[:-1].max()),
            "last_tile_chunks": int(per_tile[-1]),
        }
        plain = cuda_ms(lambda: vote_chunks.chunk_counts_plain(
            cp, cv, ct, n_tiles), 3)
        keys = chunk_keys(cp, cv, ct, n_tiles)
        lib = cuda_ms(lambda: torch.bincount(
            keys, minlength=8 * n_tiles * 256), 3)
        votes = int(keys.numel())
        # the bytes the function needs: the array that marks pads (pos in
        # the int32 layout, vocab in uint8) whole, the other one for the
        # events that are not pads, chunk_tile, and the output
        if cp.dtype == torch.int32:
            kept = int(((cp >= 0) & (cp < 256)).sum())
        else:
            kept = int((cv < 8).sum())
        n_bytes = ((cp.numel() + kept) * cp.element_size() + ct.numel() * 4
                   + 8 * n_tiles * 256 * 4)
        return ms, plain, lib, votes, n_bytes

    timed = {
        "lanes_vote_packed4": lanes_timing("lanes_vote_packed4", "packed4",
                                           e_vb, e_bt),
        "lanes_vote_packed4 (padded)": time_kernel_a(pad_vb, pad_bt,
                                                     e_ntiles, R_SUB,
                                                     TILE_W),
        "lanes_vote_bytes": lanes_timing("lanes_vote_bytes", "packed",
                                         b_vb, b_bt),
        "lanes_vote_packed8": lanes_timing("lanes_vote_packed8", "packed8",
                                           n_vb, b_bt),
        "chunk_vote": chunk_timing("chunk_vote", u_cp, u_cv, u_ct, u_tiles),
        "chunk_vote (overflow fold)": chunk_timing(
            "chunk_vote (overflow fold)", o_cp, o_cv, o_ct, ov_tiles),
        "chunk_vote (repeats)": chunk_timing(
            "chunk_vote (repeats)", r_cp, r_cv, r_ct, r_tiles),
    }
    inputs = {
        "lanes_vote_packed4": "E. coli packed4 pack",
        "lanes_vote_packed4 (padded)": "padded E. coli packed4 pack",
        "lanes_vote_bytes": "E. coli byte pack (uint8)",
        "lanes_vote_packed8": "E. coli packed8 pack",
        "chunk_vote": "E. coli events, uint8 chunks (the mxu path)",
        "chunk_vote (overflow fold)": "E. coli overflow chunks (int32)",
        "chunk_vote (repeats)": "repeats events, uint8 chunks",
    }
    bounds = {}
    for label, (ms, plain, lib, votes, n_bytes) in timed.items():
        b_ms, b_by = bound(n_bytes, votes)
        bounds[label] = (b_ms, b_by)
        print(f"{label} on {inputs[label]}: {ms:.4f} ms for {votes} votes "
              f"({votes / ms / 1e6:.2f} G votes/s), {n_bytes} B moved, "
              f"{n_bytes / ms / 1e9:.3f} TB/s; plain {plain:.3f} ms; "
              f"torch.bincount {lib:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_ms / ms:.1%} of it)")
        if label in chunk_extra:
            x = chunk_extra[label]
            print(f"{label}: chunk_counts call {x['wrapper_ms']:.4f} ms; "
                  f"deepest tile {x['deepest_tile_chunks']} chunks, last "
                  f"tile (with the pad chunks) {x['last_tile_chunks']}")
    # the overflow fold on the E. coli and repeats overflow lists, on
    # device arrays unless named: the overflow kernel alone, with one
    # event (the launch floor), the overflow_counts call, the call with
    # its upload; its plain version (add_overflow_counts, the JAX
    # package's scatter route), index_put_ alone and torch.bincount of
    # vid * width + pos on the same events; the chunk route that the
    # lanes path took before (host prepare_chunks, upload, chunk kernel,
    # add).  Every route's counts equal the kernel's.
    lib_o = vote_lanes._overflow_kernel()
    ov_timed = {}
    for label, (op, ovid), n_tiles in (("E. coli", e_ov, e_ntiles),
                                       ("repeats", r_ov, r_ntiles)):
        width = n_tiles * TILE_W

        def zeros(device=dev):
            return torch.zeros((8, width), dtype=torch.int32, device=device)

        d_op = torch.from_numpy(op).to(dev)
        d_ov = torch.from_numpy(ovid).to(dev)
        got = check_overflow(errs, f"{label} overflow list onto zeros",
                             zeros(), d_op, d_ov)
        cpu = vote_lanes.add_overflow_counts(zeros("cpu"), op, ovid)

        def chunk_route(counts):
            cp, cv, ct, nt = vote_chunks.prepare_chunks(
                op.astype(np.int64), ovid.astype(np.int32), width)
            extra = vote_chunks.chunk_counts(
                *(torch.from_numpy(a).to(dev) for a in (cp, cv, ct)), nt)
            counts += extra[:, :width]
            return counts

        chunk = chunk_route(zeros())
        torch.cuda.synchronize()
        err = max(max_abs_err(got, chunk), max_abs_err(cpu, got.cpu()))
        check(err == 0 and int(got.sum()) == int((ovid < 8).sum()),
              f"{label} overflow: kernel != chunk route / CPU plain (max "
              f"err {err})")
        acc = zeros()

        def launch(n=op.size):
            check(lib_o.overflow_vote(d_op.data_ptr(), d_ov.data_ptr(), n,
                                      acc.data_ptr(), width, stream) == 0,
                  "overflow_vote launch")

        keep = d_ov < 8
        rows, cols = d_ov[keep].to(torch.int64), d_op[keep].to(torch.int64)
        ones = torch.ones_like(rows, dtype=torch.int32)
        keys = rows * width + cols
        distinct = int(torch.unique(keys).numel())
        ov_timed[label] = {
            "events": int(op.size), "distinct": distinct,
            "ms": cuda_ms(launch, TIMED_LAUNCHES),
            "floor_ms": cuda_ms(lambda: launch(1), TIMED_LAUNCHES),
            "wrapper_ms": cuda_ms(lambda: vote_lanes.overflow_counts(
                acc, d_op, d_ov), TIMED_LAUNCHES),
            "upload_ms": cuda_ms(lambda: vote_lanes.overflow_counts(
                acc, *(torch.from_numpy(a).to(dev) for a in (op, ovid))),
                TIMED_LAUNCHES),
            "plain_ms": cuda_ms(lambda: vote_lanes.add_overflow_counts(
                acc, d_op, d_ov), TIMED_LAUNCHES),
            "index_put_ms": cuda_ms(lambda: acc.index_put_(
                (rows, cols), ones, accumulate=True), TIMED_LAUNCHES),
            "bincount_ms": cuda_ms(lambda: torch.bincount(
                keys, minlength=8 * width), TIMED_LAUNCHES),
            "chunk_route_ms": cuda_ms(lambda: chunk_route(acc), 5),
        }
        x = ov_timed[label]
        # bytes: 5 an event read once, each distinct (pos, vid) word of
        # the counts read and written once; one compare an event
        x["bytes"] = 5 * x["events"] + 8 * distinct
        x["bound_ms"], x["bound_by"] = bound(x["bytes"], x["events"])
        print(f"overflow fold, {label} ({x['events']} events, {distinct} "
              f"distinct (pos, vid), {width} positions): kernel "
              f"{x['ms']:.4f} ms, bound {x['bound_ms']:.5f} ms "
              f"({x['bound_by']}, {x['bytes']} B), one-event launch "
              f"{x['floor_ms']:.4f} ms; overflow_counts call "
              f"{x['wrapper_ms']:.4f} ms, with its upload "
              f"{x['upload_ms']:.4f} ms; plain add_overflow_counts "
              f"{x['plain_ms']:.4f} ms, index_put_ {x['index_put_ms']:.4f} "
              f"ms, torch.bincount {x['bincount_ms']:.4f} ms; chunk route "
              f"(prepare_chunks, upload, kernel, add) "
              f"{x['chunk_route_ms']:.4f} ms; counts equal")
    del acc
    print(f"overflow fold: phase 4 lanes stage kernel_b "
          f"{kernel_b_stage['ecoli50x']:.4f} s on E. coli, "
          f"{kernel_b_stage['repeats']:.4f} s on repeats")
    # the whole lanes_counts call: the host tile_row_start (block_tile's
    # copy to the host waits for the stream), its upload, the launches;
    # then as LanesPolisher calls it, with block_tile's host array
    wrapper_ms = cuda_ms(lambda: vote_lanes.lanes_counts(
        e_vb, e_bt, e_ntiles, R_SUB, TILE_W), TIMED_LAUNCHES)
    wrapper_host_ms = cuda_ms(lambda: vote_lanes.lanes_counts(
        e_vb, e_bt, e_ntiles, R_SUB, TILE_W, block_tile_host=e_bt_host),
        TIMED_LAUNCHES)
    print(f"lanes_vote_packed4: lanes_counts call {wrapper_ms:.4f} ms on "
          f"the E. coli packed4 pack, {wrapper_host_ms:.4f} ms given "
          f"block_tile's host array")
    for label, bt in (("E. coli", e_bt), ("padded E. coli", pad_bt)):
        rows = np.diff(vote_lanes.tile_row_start(
            bt.cpu().numpy(), e_ntiles,
            vote_lanes._rows_per_block(R_SUB, "packed4")))
        print(f"lanes_vote_packed4 rows of the {label} pack: deepest tile "
              f"{int(rows[:-1].max())} int32 rows, last tile "
              f"{int(rows[-1])}")
    del pad_vb, pad_bt

    # -- phases 7-9: windowed polish, default windows, filter and full -
    ctx = dict(dev=dev, zero_counts=zero_counts, read_counts=read_counts,
               kernels=KERNELS, errs=errs, check_lanes=check_lanes,
               check_chunks=check_chunks, launches=launches)
    phase_windowed_ecoli(ctx, cases["ecoli50x"], host_runs["ecoli50x"])
    phase_default_windows(ctx)
    cases["repeats16"] = phase_filter_full(ctx, cases)

    # -- phases 10-12: event stream, batch, auto and pod shards --------
    phase_event_path(ctx, cases["ecoli50x"], host_runs["ecoli50x"])
    phase_batch(ctx, cases, host_runs)
    phase_auto_pod(ctx, cases, host_runs, pack_bytes)

    # -- phase 13: sharded grids, gloo ranks, batch across hosts -------
    uncapped = phase_sharded_pod(ctx, cases, host_runs)

    def entry(name, source, replaces, label):
        ms, plain, lib, _, _ = timed[label]
        return {"name": name, "route": "cuda",
                "source": f"polypolish_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
                "bound_ms": bounds[label][0], "bound_by": bounds[label][1],
                "library_ms": lib}

    vl, vp = "polypolish_tpu/ops/vote_lanes.py", \
        "polypolish_tpu/ops/vote_pallas.py"
    kernels = [
        entry("lanes_vote_packed4", "lanes_vote.cu", f"{vl}:143",
              "lanes_vote_packed4"),
        entry("lanes_vote_bytes", "lanes_vote.cu",
              f"{vl}:169 (packed), {vl}:178 (cmp)", "lanes_vote_bytes"),
        entry("lanes_vote_packed8", "lanes_vote.cu", f"{vl}:106",
              "lanes_vote_packed8"),
        entry("chunk_vote", "chunk_vote.cu",
              f"{vp}:144 (split), {vp}:99 (fused), {vp}:60 (unfused)",
              "chunk_vote"),
    ]
    # kernel A on the uncapped 1x1 E. coli mesh pack of phase 13, on the
    # padded capped pack, and the whole lanes_counts call
    ms, plain, lib, votes, n_bytes = uncapped
    b_ms, _ = bound(n_bytes, votes)
    kernels[0].update({"uncapped_ms": ms, "uncapped_plain_ms": plain,
                       "uncapped_bound_ms": b_ms,
                       "uncapped_library_ms": lib})
    label = "lanes_vote_packed4 (padded)"
    kernels[0].update({"padded_ms": timed[label][0],
                       "padded_plain_ms": timed[label][1],
                       "padded_bound_ms": bounds[label][0],
                       "padded_library_ms": timed[label][2],
                       "wrapper_ms": wrapper_ms,
                       "wrapper_host_block_tile_ms": wrapper_host_ms})
    # the overflow fold on the E. coli list; the same on repeats, and
    # the other PyTorch calls on the same events, as extra keys
    x = ov_timed["E. coli"]
    overflow = {"name": "overflow_vote", "route": "cuda",
                "source": "polypolish_tpu_torch/csrc/overflow_vote.cu",
                "replaces": f"{vp}:144 (split, over the overflow list)",
                "launches": launches["overflow_vote"],
                "max_abs_err": errs["overflow_vote"], "ms": x["ms"],
                "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
                "bound_by": x["bound_by"], "library_ms": x["index_put_ms"]}
    for prefix, label in (("", "E. coli"), ("repeats_", "repeats")):
        x = ov_timed[label]
        overflow.update({f"{prefix}{k}": x[k] for k in (
            "events", "distinct", "floor_ms", "wrapper_ms", "upload_ms",
            "bincount_ms", "chunk_route_ms")})
        if prefix:
            overflow.update({f"{prefix}{k}": x[k] for k in (
                "ms", "plain_ms", "bound_ms", "index_put_ms")})
    overflow["kernel_b_stage_s"] = kernel_b_stage["ecoli50x"]
    overflow["repeats_kernel_b_stage_s"] = kernel_b_stage["repeats"]
    kernels.append(overflow)
    for role in ("overflow fold", "repeats"):
        label = f"chunk_vote ({role})"
        key = role.replace(" ", "_")
        kernels[3].update({f"{key}_ms": timed[label][0],
                            f"{key}_plain_ms": timed[label][1],
                            f"{key}_bound_ms": bounds[label][0],
                            f"{key}_library_ms": timed[label][2]})
    for k in kernels:
        check(k["launches"] > 0 and k["max_abs_err"] == 0,
              f"kernel {k['name']}: {k['launches']} launches, max err "
              f"{k['max_abs_err']}")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    print(f"chip_smoke total {time.monotonic() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# -- phases 7-9 --------------------------------------------------------

WINDOW_ENV = ("POLYPOLISH_TPU_WINDOW_MIN", "POLYPOLISH_TPU_WINDOW",
              "POLYPOLISH_TPU_WINDOW_DEPTH")
BIG_LEN = 33_600_000  # four full 8 Mb windows and a tail
BIG_COVERAGE = 50.0
GRID_MIN = 1_000_000  # the filter's device grid threshold


@contextlib.contextmanager
def window_env(**env):
    """The window settings given (unset: the defaults) for one run."""
    old = {k: os.environ.get(k) for k in WINDOW_ENV}
    for k in WINDOW_ENV:
        os.environ.pop(k, None)
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def polish_run(ctx, fasta, sams, timer=None, **kwargs):
    """(FASTA, stderr with the clock masked, wall s, launches, timer) of
    one polish call, the launch counters zeroed just before it."""
    from polypolish_tpu_torch.pipeline.polish import polish
    from polypolish_tpu_torch.utils.profiling import StageTimer

    timer = timer if timer is not None else StageTimer()
    out, err = io.StringIO(), io.StringIO()
    ctx["zero_counts"]()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err):
        polish(None, 0.2, 0.5, 10, 5, False, fasta, sams, out=out,
               device=ctx["dev"], timer=timer, **kwargs)
    if ctx["dev"].type == "cuda":
        torch.cuda.synchronize()
    total = time.monotonic() - t0
    counts = ctx["read_counts"]()
    return out.getvalue(), _CLOCK.sub("", err.getvalue()), total, counts, \
        timer


def window_plan(fasta, sams, w_pad, ctx=None, check_windows=()):
    """(windows, windows with cap-overflow events) of the device twin
    over a single-contig workload: what it must launch kernel A and
    the overflow kernel for.  For each window index in ``check_windows``
    (negative: from the end), kernel A on that window's pack and the
    overflow kernel on its overflow list are held bitwise against their
    plain versions on the same tensors, and their sum against the host
    fold of the window (and zero on the pad positions past its end)."""
    from polypolish_tpu_torch.ops import vote_lanes

    pr, name, P, _, _ = parse(fasta, sams)
    n_want = -(-P // w_pad)
    to_check = {k % n_want for k in check_windows}
    try:
        n_win = n_ov = 0
        for k, w_lo in enumerate(range(0, P, w_pad)):
            pack = pr.lanes(name, vote_lanes.R_SUB, vote_lanes.TILE_W,
                            num_positions=w_pad, packed4=True, cap=True,
                            w_lo=w_lo)
            check(pack is not None, f"window pack at {w_lo}")
            n_win += 1
            n_ov += pack.n_overflow > 0
            try:
                if k in to_check:
                    check_window_kernels(ctx, pr, name, pack, w_lo,
                                         min(P, w_lo + w_pad), w_pad,
                                         vote_lanes)
            finally:
                pack.close()
    finally:
        pr.close()
    check(n_win == n_want, f"{n_win} windows of {w_pad} over {P}")
    return n_win, n_ov


def check_overflow(errs, label, counts, ov_pos, ov_vid):
    """The overflow vote kernel against its plain version, bitwise, each
    adding the list (device tensors) onto a copy of ``counts``; returns
    the kernel's counts."""
    from polypolish_tpu_torch.ops import vote_lanes

    got = vote_lanes.overflow_counts(counts.clone(), ov_pos, ov_vid)
    want = vote_lanes.add_overflow_counts(counts.clone(), ov_pos, ov_vid)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"overflow_vote != plain on {label} (max err {err})")
    errs["overflow_vote"] = max(errs["overflow_vote"], err)
    print(f"overflow_vote == plain on {label}: {ov_pos.numel()} events "
          f"into {tuple(counts.shape)}, {int((got - counts).sum())} votes")
    return got


def check_window_kernels(ctx, pr, name, pack, w_lo, w_hi, w_pad,
                         vote_lanes):
    """Kernel A and the overflow kernel against their plain versions on
    one window of the device twin, at the shapes it gives them."""
    dev, errs = ctx["dev"], ctx["errs"]
    label = f"window [{w_lo}, {w_hi}) of {w_pad}"
    n_tiles = w_pad // vote_lanes.TILE_W
    check(pack.n_tiles == n_tiles, f"{label}: {pack.n_tiles} tiles")
    vb = torch.from_numpy(pack.vb).to(dev)
    bt = torch.from_numpy(pack.block_tile).to(dev)
    args = (vb, bt, n_tiles, vote_lanes.R_SUB, vote_lanes.TILE_W)
    got = vote_lanes.lanes_counts(*args)
    want = vote_lanes.lanes_counts_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    check(err == 0, f"lanes_vote_packed4 != plain on {label} (max err {err})")
    errs["lanes_vote_packed4"] = max(errs["lanes_vote_packed4"], err)
    total = got
    n_ov = int(pack.n_overflow)
    if n_ov:
        total = check_overflow(
            errs, f"{label} overflow list", got,
            *(torch.from_numpy(a).to(dev) for a in (pack.ov_pos,
                                                    pack.ov_vid)))
    host = pr.fold_window(name, w_lo, w_hi, (5, 0.5, 0.2))[0]
    w_real = w_hi - w_lo
    check(np.array_equal(total[:, :w_real].cpu().numpy(), host)
          and int(total[:, w_real:].abs().sum()) == 0,
          f"{label}: kernel A + overflow kernel counts != host window fold")
    print(f"lanes_vote_packed4 and overflow_vote == plain on {label}: "
          f"{tuple(vb.shape)} rows, {n_ov} overflow events, "
          f"{int(want.sum())} + {n_ov} votes == host window fold, "
          f"{w_pad - w_real} pad positions empty")


def check_window_launches(ctx, label, counts, n_win, n_ov):
    want = {k: 0 for k in ctx["kernels"]}
    want["lanes_vote_packed4"] = n_win
    want["overflow_vote"] = n_ov
    check(counts == want, f"{label}: launches {counts}, want {want}")


def laps_by_window(timer, first="fold"):
    """The timer's laps cut at each ``first`` stage: one dict of stage
    seconds per loop iteration of a windowed path."""
    out = []
    for name, dt in timer.laps:
        if name == first:
            out.append({})
        if out:  # the stages before the first window's fold are not its
            out[-1][name] = out[-1].get(name, 0.0) + dt
    return out


def fmt_stages(stages):
    # six decimals: the kernel stages take microseconds
    return " ".join(f"{k} {v:.6f}" for k, v in stages.items())


def phase_windowed_ecoli(ctx, case, host_ref):
    """Phase 7: E. coli through the windowed paths at 1 Mi windows
    (five windows), the device twin with POLYPOLISH_TPU_WINDOW_DEPTH at
    1, 2, 3, 2 and 1 and the host twin, each equal to the unwindowed
    host run of phase 4."""
    from polypolish_tpu_torch.ops.vote_lanes import TILE_W
    from polypolish_tpu_torch.utils.profiling import StageTimer

    t0 = time.monotonic()
    fasta, sams = case
    window = 1 << 20
    w_pad = -(-window // TILE_W) * TILE_W
    n_win, n_ov = window_plan(fasta, sams, w_pad, ctx, check_windows=(1, -1))
    print(f"windowed ecoli50x: window {window}, w_pad {w_pad}, {n_win} "
          f"windows, {n_ov} with overflow events")
    runs = [(f"device depth {d}{' again' if k > 2 else ''}",
             dict(backend="device"), d, None)
            for k, d in enumerate((1, 2, 3, 2, 1))]
    runs += [("host twin", dict(backend="host"), 2, None),
            ("device depth 2, synchronising timer", dict(backend="device"),
             2, StageTimer(sync_device=ctx["dev"]))]
    for label, kwargs, depth, timer in runs:
        with window_env(POLYPOLISH_TPU_WINDOW_MIN=1,
                        POLYPOLISH_TPU_WINDOW=window,
                        POLYPOLISH_TPU_WINDOW_DEPTH=depth):
            fasta_out, err, total, counts, timer = polish_run(
                ctx, fasta, sams, timer, **kwargs)
        check(fasta_out == host_ref[0],
              f"windowed ecoli50x {label}: FASTA != unwindowed host FASTA")
        check(err == host_ref[1],
              f"windowed ecoli50x {label}: stderr != unwindowed host stderr")
        if kwargs["backend"] == "device":
            check_window_launches(ctx, f"windowed ecoli50x {label}", counts,
                                  n_win, n_ov)
        else:
            check(sum(counts.values()) == 0,
                  f"windowed host twin launched a kernel {counts}")
        print(f"windowed ecoli50x {label}: total {total:.3f} s | "
              f"{fmt_stages(timer.seconds)} | launches {counts}")
        if timer.sync_device is not None:
            for k, stages in enumerate(laps_by_window(timer)):
                print(f"  window iteration {k}: {fmt_stages(stages)}")
    print("windowed ecoli50x: FASTA and stderr == unwindowed host on every "
          "run")
    print(f"phase 7 (windowed E. coli): {time.monotonic() - t0:.1f} s")


def phase_default_windows(ctx):
    """Phase 8: one 33.6 Mb contig at the default window settings (8 Mb
    windows): the device twin and the host twin agree."""
    import workload
    from polypolish_tpu_torch.ops.vote_lanes import TILE_W
    from polypolish_tpu_torch.pipeline.polish import _window_size
    from polypolish_tpu_torch.utils.profiling import StageTimer

    t0 = time.monotonic()
    fasta_t, sams_t, info = workload.make_paired_case(
        seed=0, genome_len=BIG_LEN, coverage=BIG_COVERAGE)
    fasta, sams = workload.write_case(DATA_DIR, "contig33m", fasta_t, sams_t)
    del fasta_t, sams_t
    sam_bytes = sum(os.path.getsize(p) for p in sams)
    print(f"33.6 Mb workload: {BIG_LEN} bp at {BIG_COVERAGE}x, "
          f"{info['n_alignments']} alignments, {sam_bytes} B of SAM, made "
          f"in {time.monotonic() - t0:.1f} s")
    with window_env():
        w_pad = -(-_window_size() // TILE_W) * TILE_W
        n_win, n_ov = window_plan(fasta, sams, w_pad, ctx,
                                  check_windows=(1, -1))
        print(f"33.6 Mb: w_pad {w_pad}, {n_win} windows, {n_ov} with "
              f"overflow events")
        # the peak counts what earlier phases still hold on the card
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dev_run = polish_run(ctx, fasta, sams, backend="device")
        peak = torch.cuda.max_memory_allocated()
        sync_run = polish_run(ctx, fasta, sams,
                              StageTimer(sync_device=ctx["dev"]),
                              backend="device")
        host_run = polish_run(ctx, fasta, sams, backend="host")
    for label, run in (("device twin", dev_run),
                       ("device twin, synchronising timer", sync_run),
                       ("host twin", host_run)):
        fasta_out, err, total, counts, timer = run
        check(fasta_out == host_run[0] and err == host_run[1],
              f"33.6 Mb {label}: FASTA or stderr != host twin")
        if label.startswith("device"):
            check_window_launches(ctx, f"33.6 Mb {label}", counts, n_win,
                                  n_ov)
        print(f"33.6 Mb {label}: total {total:.3f} s | "
              f"{fmt_stages(timer.seconds)} | launches {counts}")
        for k, stages in enumerate(laps_by_window(timer)):
            if label != "device twin":
                print(f"  window iteration {k}: {fmt_stages(stages)}")
    check(host_run[0].startswith(">") and host_run[0].count("\n") == 2,
          "33.6 Mb: malformed FASTA")
    print(f"33.6 Mb: device twin FASTA == host twin FASTA "
          f"({len(host_run[0])} bytes), stderr equal; peak device memory "
          f"of the device twin {peak} B, {peak - held} B above the {held} B "
          f"held before it")
    for p in sams + [fasta]:
        os.remove(p)
    print(f"phase 8 (33.6 Mb at the default windows): "
          f"{time.monotonic() - t0:.1f} s")


def file_digest(path):
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def phase_filter_full(ctx, cases):
    """Phase 9: filter on ecoli50x, repeats and repeats16 through the
    device grid step against numpy deciding every verdict; full on
    ecoli50x against filter + polish on the host backend."""
    import workload
    from polypolish_tpu_torch.models.pairscreen import pair_screen_step
    from polypolish_tpu_torch.pipeline import filtering
    from polypolish_tpu_torch.pipeline.full import polish_paired
    from polypolish_tpu_torch.pipeline.polish import _pad_bucket

    t0 = time.monotonic()
    fasta_t, sams_t, _ = workload.make_paired_case(
        seed=0, repeat_len=5000, repeat_copies=16)
    cases = dict(cases)
    cases["repeats16"] = workload.write_case(DATA_DIR, "repeats16", fasta_t,
                                             sams_t)
    del fasta_t, sams_t
    print(f"repeats16 workload made in {time.monotonic() - t0:.1f} s")
    threshold = filtering._DEVICE_GRID_THRESHOLD
    check(threshold == GRID_MIN, f"grid threshold {threshold}")
    for case in ("ecoli50x", "repeats", "repeats16"):
        in1, in2 = cases[case][1]
        outs = [os.path.join(DATA_DIR, f"{case}_filtered_{i}.sam")
                for i in (1, 2)]
        with contextlib.redirect_stderr(io.StringIO()):
            files = filtering.load_alignments(in1, in2)
        grids = [filtering.pair_grid(files[w], files[1 - w]).seg.size
                 for w in (0, 1)]
        del files
        results = {}
        for label, thr in (("device step", threshold), ("numpy", 1 << 62)):
            filtering._DEVICE_GRID_THRESHOLD = thr
            pair_screen_step.launches = 0
            err = io.StringIO()
            t1 = time.monotonic()
            try:
                with contextlib.redirect_stderr(err):
                    counts = filtering.filter_pairs(in1, in2, *outs,
                                                    device=ctx["dev"])
            finally:
                filtering._DEVICE_GRID_THRESHOLD = threshold
            total = time.monotonic() - t1
            steps = pair_screen_step.launches
            results[label] = (counts, [file_digest(p) for p in outs],
                              _CLOCK.sub("", err.getvalue()))
            passes = re.findall(r"([\d,]+) (pass|fail)", err.getvalue())
            print(f"filter {case} ({label}): total {total:.3f} s | grid "
                  f"entries per file {grids} | device steps {steps} | "
                  f"alignments before/after {counts} | "
                  f"{' '.join(' '.join(x) for x in passes)}")
            want_steps = sum(g >= thr for g in grids)
            check(steps == want_steps,
                  f"filter {case} ({label}): {steps} device steps, want "
                  f"{want_steps}")
        check(results["device step"] == results["numpy"],
              f"filter {case}: device-step run != numpy run (SAMs, counts "
              f"or stderr)")
        if case == "repeats16":
            check(min(grids) >= GRID_MIN,
                  f"repeats16 grids {grids} below {GRID_MIN}")
        print(f"filter {case}: output SAMs byte-identical, pass and fail "
              f"counts equal to numpy deciding every verdict")
        if case != "ecoli50x":
            for p in outs:
                os.remove(p)

    # full on ecoli50x == filter, then polish on the host backend
    fasta, (in1, in2) = cases["ecoli50x"]
    filtered = [os.path.join(DATA_DIR, f"ecoli50x_filtered_{i}.sam")
                for i in (1, 2)]
    host_out = polish_run(ctx, fasta, filtered, backend="host")
    out = io.StringIO()
    ctx["zero_counts"]()
    t1 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):
        polish_paired(fasta, in1, in2, out=out, device=ctx["dev"],
                      keep_filtered=os.path.join(DATA_DIR, "full"))
    total = time.monotonic() - t1
    counts = ctx["read_counts"]()
    check(out.getvalue() == host_out[0],
          "full ecoli50x FASTA != filter + host polish FASTA")
    # unwindowed lanes path (4.6 Mb): one pack over the padded contig
    with open(fasta) as f:
        f.readline()
        P = len(f.readline().strip())
    n_win, n_ov = window_plan(fasta, filtered, _pad_bucket(P))
    check_window_launches(ctx, "full ecoli50x", counts, n_win, n_ov)
    print(f"full ecoli50x: total {total:.3f} s | launches {counts} | FASTA "
          f"== filter + host polish ({len(host_out[0])} bytes)")
    shutil.rmtree(os.path.join(DATA_DIR, "full"))
    for p in filtered:
        os.remove(p)
    print(f"phase 9 (filter and full): {time.monotonic() - t0:.1f} s")
    return cases["repeats16"]


# -- phases 10-12 -----------------------------------------------------

# the cut genome of the pure-Python runs: 100 kb, because the six runs
# at 200 kb (10-14 s each in the Python reader) took 72 s of the script
CUT_LEN = 100_000
CAL_REPS = 3  # warm host and lanes runs behind the cost model's constants
SEQ16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"


def sam_to_bgzf_bam(sam_path: str, bam_path: str) -> None:
    """Write the records of a SAM file (the workload's: @SQ header,
    integer and string tags) as a BGZF-compressed BAM (SAM spec section
    4), for the port's own BAM reader to read back."""
    import struct
    import zlib

    code = bytes(SEQ16.index(c) if c in SEQ16 else 15 for c in
                 (chr(i).upper() for i in range(256)))
    header, refs, body = [], {}, bytearray()
    with open(sam_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
                if line.startswith("@SQ"):
                    fields = dict(x.split(":", 1) for x in line.split("\t")[1:])
                    refs[fields["SN"]] = (len(refs), int(fields["LN"]))
                continue
            (qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq,
             qual, *tags) = line.split("\t")
            ref_id = refs[rname][0] if rname in refs else -1
            next_ref = (ref_id if rnext == "=" else
                        refs[rnext][0] if rnext in refs else -1)
            ops = [(int(n) << 4) | CIGAR_OPS.index(op)
                   for n, op in re.findall(r"(\d+)(\D)", cigar)]
            l_seq = 0 if seq == "*" else len(seq)
            nib = seq.encode("latin-1").translate(code) if l_seq else b""
            if l_seq % 2:
                nib += b"\x00"
            packed = bytes(a << 4 | b for a, b in zip(nib[::2], nib[1::2]))
            qb = (b"\xff" * l_seq if qual == "*" else
                  bytes(ord(c) - 33 for c in qual)) if l_seq else b""
            tb = bytearray()
            for t in tags:
                tag, typ, val = t.split(":", 2)
                if typ == "i":
                    tb += tag.encode() + b"i" + struct.pack("<i", int(val))
                else:
                    tb += tag.encode() + typ.encode() + val.encode() + b"\0"
            name_b = qname.encode() + b"\0"
            rec = struct.pack("<iiBBHHHIiii", ref_id, int(pos) - 1,
                              len(name_b), int(mapq), 0, len(ops), int(flag),
                              l_seq, next_ref, int(pnext) - 1, int(tlen))
            rec += name_b + b"".join(struct.pack("<I", o) for o in ops)
            rec += packed + qb + bytes(tb)
            body += struct.pack("<I", len(rec)) + rec
    text = ("\n".join(header) + "\n").encode()
    head = bytearray(b"BAM\x01" + struct.pack("<I", len(text)) + text
                     + struct.pack("<i", len(refs)))
    for name, (_, length) in refs.items():
        nb = name.encode() + b"\0"
        head += struct.pack("<I", len(nb)) + nb + struct.pack("<i", length)
    payload = bytes(head + body)
    with open(bam_path, "wb") as out:
        for off in range(0, len(payload), 60000):
            chunk = payload[off:off + 60000]
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            cdata = co.compress(chunk) + co.flush()
            out.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                      + struct.pack("<H", 6) + b"BC"
                      + struct.pack("<HH", 2, len(cdata) + 25) + cdata
                      + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
        out.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))


def cli_run(ctx, argv):
    """(stdout, stderr with the clock masked, wall s, launches) of one
    in-process ``python -m polypolish_tpu_torch`` command, the launch
    counters zeroed just before it."""
    from polypolish_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    ctx["zero_counts"]()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    total = time.monotonic() - t0
    counts = ctx["read_counts"]()
    check(rc == 0, f"{' '.join(argv)}: exit code {rc}\n{err.getvalue()}")
    return out.getvalue(), _CLOCK.sub("", err.getvalue()), total, counts


def rss_kb(field: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    raise RuntimeError(f"no {field} in /proc/self/status")


class RssPeak:
    """Peak VmRSS of this process while the block runs, sampled every
    5 ms on a thread (the kernel's own peak, VmHWM, can be restarted
    for one phase only where /proc/self/clear_refs is writable)."""

    def __enter__(self):
        self.start = self.peak = rss_kb("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, rss_kb("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_kb("VmRSS"))
        return False


def contig_len(fasta: str) -> int:
    with open(fasta) as f:
        f.readline()
        return len(f.readline().strip())


def no_launches(counts):
    return sum(counts.values()) == 0


@contextlib.contextmanager
def capture_calls(**wrappers):
    """Record the arguments of every call the models and the grid step
    make to the kernel wrappers named (attributes of models/polisher.py
    and parallel/shard.py, which call them) while the block runs; each
    call goes through unchanged.  Yields {name: [args, ...]}."""
    from polypolish_tpu_torch.models import polisher
    from polypolish_tpu_torch.parallel import shard

    calls = {name: [] for name in wrappers}
    originals = {(mod, name): getattr(mod, name)
                 for mod in (polisher, shard) for name in wrappers
                 if hasattr(mod, name)}

    def recorder(key):
        fn = originals[key]
        name = key[1]

        def call(*args, **kwargs):
            # copies, taken before the call (overflow_counts adds in
            # place): a caller may free what a tensor or array aliases
            # (a native pack) once the call returns
            def copy(a):
                if torch.is_tensor(a):
                    return a.clone()
                return a.copy() if isinstance(a, np.ndarray) else a

            calls[name].append((tuple(copy(a) for a in args),
                                {k: copy(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)

        return call

    for mod, name in originals:
        setattr(mod, name, recorder((mod, name)))
    try:
        yield calls
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def check_captured(ctx, label, calls):
    """Each kernel call a main path made, run again through its wrapper
    and held bitwise against its plain version on the same tensors."""
    for i, (args, kwargs) in enumerate(calls.get("lanes_counts", ())):
        ctx["check_lanes"](f"{label}, kernel A call {i}", *args, **kwargs)
    for i, (args, kwargs) in enumerate(calls.get("overflow_counts", ())):
        check_overflow(ctx["errs"], f"{label}, overflow kernel call {i}",
                       *args, **kwargs)
    for i, (args, kwargs) in enumerate(calls.get("chunk_counts", ())):
        ctx["check_chunks"](f"{label}, chunk kernel call {i}", *args,
                            **kwargs)


def phase_event_path(ctx, case, host_ref):
    """Phase 10: the pure-Python reader's event-stream path, at full
    E. coli size through polish_sequences and at a cut genome through
    the CLI (SAM and BAM)."""
    import importlib

    import workload
    from polypolish_tpu_torch.utils.profiling import StageTimer
    from polypolish_tpu_torch.vocab import Vocab

    # the pipeline package exports polish(), which hides the module
    pp = importlib.import_module("polypolish_tpu_torch.pipeline.polish")
    t0 = time.monotonic()
    dev = ctx["dev"]
    fasta, sams = case
    timer = StageTimer(sync_device=dev)
    out, err = io.StringIO(), io.StringIO()
    ctx["zero_counts"]()
    t1 = time.monotonic()
    with RssPeak() as rss, contextlib.redirect_stderr(err):
        start = time.monotonic()
        pp.starting_message(None, 0.2, 0.5, 10, 5, False, fasta, sams)
        seq_names, votes = pp.load_assembly(fasta)
        vocab = Vocab()
        with timer.stage("parse"):
            pr = pp._load_alignments_runs(10, False, sams, votes, vocab, None)
        try:
            with timer.stage("events"):
                for name, _ in seq_names:
                    votes[name].extend_events(*pr.events(name))
        finally:
            pr.close()
        n_events = sum(v.num_events for v in votes.values())
        with capture_calls(chunk_counts=True) as calls:
            lengths = pp.polish_sequences(
                None, 0.2, 0.5, 5, seq_names, votes, vocab, out, "device",
                None, dev, timer, "lanes")
        pp.finished_message(None, lengths, start)
    total = time.monotonic() - t1
    counts = ctx["read_counts"]()
    del votes
    check(out.getvalue() == host_ref[0],
          "event path (device): FASTA != host FASTA")
    check(_CLOCK.sub("", err.getvalue()) == host_ref[1],
          "event path (device): stderr != host stderr")
    want = {k: 0 for k in ctx["kernels"]}
    want["chunk_vote"] = 1
    check(counts == want, f"event path launches {counts}, want {want}")
    print(f"event path ecoli50x (device): total {total:.3f} s | "
          f"{fmt_stages(timer.seconds)} | {n_events} events | launches "
          f"{counts} | host RSS {rss.start * 1024} B before, peak "
          f"{rss.peak * 1024} B ({(rss.peak - rss.start) * 1024} B above)")
    print("event path ecoli50x: FASTA and stderr == host run of phase 4")
    # the int32 chunks (widened on the card from pack()'s int16/int8) of
    # the whole pileup, as the path fed them to the kernel
    check_captured(ctx, "event path ecoli50x", calls)
    del calls

    # the cut genome through the CLI, from SAM and from BAM
    t1 = time.monotonic()
    fasta_t, sams_t, info = workload.make_paired_case(seed=0,
                                                      genome_len=CUT_LEN)
    cut_fasta, cut_sams = workload.write_case(DATA_DIR, "cut", fasta_t,
                                              sams_t)
    del fasta_t, sams_t
    bams = [p[:-4] + ".bam" for p in cut_sams]
    for s_path, b_path in zip(cut_sams, bams):
        sam_to_bgzf_bam(s_path, b_path)
    print(f"cut genome: {CUT_LEN} bp, {info['n_alignments']} alignments, "
          f"SAM {sum(map(os.path.getsize, cut_sams))} B, BAM "
          f"{sum(map(os.path.getsize, bams))} B, made in "
          f"{time.monotonic() - t1:.1f} s")
    native = polish_run(ctx, cut_fasta, cut_sams, backend="host")[0]
    for label, inputs in (("SAM", cut_sams), ("BAM", bams)):
        errs_by_backend = {}
        for backend in ("host", "device", "xla"):
            with capture_calls(chunk_counts=True) as calls:
                fasta_out, err_text, total, counts = cli_run(
                    ctx, ["polish", "--pure-python", "--backend", backend,
                          cut_fasta, *inputs])
            check(fasta_out == native,
                  f"--pure-python {label} {backend}: FASTA != native host")
            want = {k: 0 for k in ctx["kernels"]}
            want["chunk_vote"] = int(backend == "device")
            check(counts == want, f"--pure-python {label} {backend}: "
                                  f"launches {counts}, want {want}")
            errs_by_backend[backend] = err_text
            print(f"--pure-python {label} --backend {backend}: total "
                  f"{total:.3f} s | launches {counts}")
            check_captured(ctx, f"--pure-python {label} {backend}", calls)
        check(len(set(errs_by_backend.values())) == 1,
              f"--pure-python {label}: stderr differs between backends")
    print(f"--pure-python: six FASTAs (SAM and BAM x host, device, xla) == "
          f"native host run ({len(native)} bytes)")
    for p in cut_sams + bams + [cut_fasta]:
        os.remove(p)
    print(f"phase 10 (event-stream path): {time.monotonic() - t0:.1f} s")


def phase_batch(ctx, cases, host_runs):
    """Phase 11: batch --backend device over six jobs with one and three
    workers, then --resume."""
    from polypolish_tpu_torch.pipeline.polish import _pad_bucket

    t0 = time.monotonic()
    genomes = ("ecoli50x", "repeats", "repeats16")
    host_runs["repeats16"] = polish_run(ctx, *cases["repeats16"],
                                        backend="host")[:2]
    host = {g: host_runs[g][0] for g in genomes}
    n_ov = {}
    for g in genomes:
        fasta, sams = cases[g]
        n_ov[g] = window_plan(fasta, sams, _pad_bucket(contig_len(fasta)))[1]
    jobs = [(g, os.path.join(DATA_DIR, f"batch_{g}_{k}.fasta"))
            for g in genomes for k in (1, 2)]
    manifest = os.path.join(DATA_DIR, "batch.tsv")
    with open(manifest, "w") as f:
        for g, out_path in jobs:
            fasta, sams = cases[g]
            f.write(f"{fasta}\t{out_path}\t{','.join(sams)}\n")
    want = {k: 0 for k in ctx["kernels"]}
    want["lanes_vote_packed4"] = len(jobs)
    want["overflow_vote"] = sum(n_ov[g] for g, _ in jobs)
    walls = {}
    for workers in (1, 3):
        # the first run's kernel inputs are held against plain below
        with (capture_calls(lanes_counts=True, overflow_counts=True,
                            chunk_counts=True)
              if workers == 1 else contextlib.nullcontext({})) as calls:
            _, err, total, counts = cli_run(
                ctx, ["batch", "--backend", "device", "--workers",
                      str(workers), manifest])
        check(f"Genomes polished: {len(jobs)}/{len(jobs)}" in err,
              f"batch --workers {workers}: {err}")
        check(counts == want,
              f"batch --workers {workers}: launches {counts}, want {want}")
        for g, out_path in jobs:
            with open(out_path) as f:
                check(f.read() == host[g],
                      f"batch --workers {workers}: {out_path} != host FASTA")
        walls[workers] = total
        print(f"batch --backend device --workers {workers}: total "
              f"{total:.3f} s for {len(jobs)} genomes | launches {counts}")
        # every lane pack and overflow list of the six jobs (ecoli50x,
        # repeats and repeats16, each twice), kernel against plain
        if calls:
            check(len(calls["lanes_counts"]) == len(jobs)
                  and len(calls["overflow_counts"]) == want["overflow_vote"]
                  and not calls["chunk_counts"],
                  f"batch captured {len(calls['lanes_counts'])} lane packs, "
                  f"{len(calls['overflow_counts'])} overflow lists, "
                  f"{len(calls['chunk_counts'])} chunk streams")
            check_captured(ctx, f"batch --workers {workers}", calls)
        del calls
    _, err, total, counts = cli_run(
        ctx, ["batch", "--backend", "device", "--resume", manifest])
    check(f"{len(jobs)} resumed/skipped" in err and no_launches(counts),
          f"batch --resume: launches {counts}\n{err}")
    print(f"batch --resume: total {total:.3f} s, all {len(jobs)} skipped, "
          f"launches {counts}")
    print(f"batch: every output == its genome's host FASTA; workers 3 / "
          f"workers 1 wall {walls[3] / walls[1]:.3f}")
    for _, out_path in jobs:
        os.remove(out_path)
    print(f"phase 11 (batch): {time.monotonic() - t0:.1f} s")


def phase_auto_pod(ctx, cases, host_runs, pack_bytes):
    """Phase 12: the transport cost model and --backend auto, then
    --pod-shards 4 against the host backend."""
    from polypolish_tpu_torch.utils import transport
    from polypolish_tpu_torch.utils.profiling import StageTimer

    t0 = time.monotonic()
    fasta, sams = cases["ecoli50x"]
    sam_bytes = sum(os.path.getsize(p) for p in sams)
    bw, lat = transport.measure_link(refresh=True)
    choice, details = transport.predict_backend(sam_bytes)
    print(f"link: {bw:.6g} B/s, latency {lat:.6g} s (pageable 4 MiB and "
          f"4 KiB copies)")
    print(f"predict_backend({sam_bytes} B of SAM): {details} -> {choice}")
    # the model's constants as this run measures them: medians of warm
    # host and lanes runs on E. coli, taken in turn
    hosts, lanes_totals, halves, cards = [], [], [], []
    for _ in range(CAL_REPS):
        fasta_out, _, total, _, _ = polish_run(ctx, fasta, sams,
                                               backend="host")
        check(fasta_out == host_runs["ecoli50x"][0], "calibration host run")
        hosts.append(total)
        fasta_out, _, total, _, timer = polish_run(
            ctx, fasta, sams, StageTimer(sync_device=ctx["dev"]),
            backend="device")
        lanes_totals.append(total)
        check(fasta_out == host_runs["ecoli50x"][0], "calibration lanes run")
        st = timer.seconds
        halves.append(st["parse"] + st["fold"] + st["pack"])
        cards.append(sum(st.get(k, 0.0) for k in
                         ("kernel_a", "kernel_b", "consensus", "fetch")))
    print(f"calibration runs: host totals {[round(x, 3) for x in hosts]}, "
          f"lanes totals {[round(x, 3) for x in lanes_totals]}, "
          f"lanes parse+fold+pack {[round(x, 3) for x in halves]}, lanes "
          f"kernel_a+kernel_b+consensus+fetch {[round(x, 4) for x in cards]}")
    host_total, lanes_total, host_half, card = (
        float(np.median(x)) for x in (hosts, lanes_totals, halves, cards))
    # KERNEL_EPS_S is what the lanes path spends beyond the model's other
    # terms (the card's work, the threshold upload, finish, the syncs),
    # so that the model gives back both measured totals
    up_frac = pack_bytes / sam_bytes
    eps = (lanes_total - host_half - sam_bytes * up_frac / bw
           - transport.N_DISPATCH * lat)
    rate, speedup = sam_bytes / host_total, host_total / host_half
    slope = (1 - 1 / speedup) / rate - up_frac / bw
    cross = f"{eps / slope:.4g} B" if slope > 0 else "none"
    print(f"calibration from this run: HOST_ENGINE_BYTES_PER_S {rate:.6g} "
          f"(module {transport.HOST_ENGINE_BYTES_PER_S:g}), PARSE_SPEEDUP "
          f"{speedup:.4f} (module {transport.PARSE_SPEEDUP:g}), "
          f"UPLOAD_FRACTION {up_frac:.4f} (module "
          f"{transport.UPLOAD_FRACTION:g}), KERNEL_EPS_S {eps:.4f} (module "
          f"{transport.KERNEL_EPS_S:g}; of it kernel_a+kernel_b+consensus+"
          f"fetch {card:.4f}), N_DISPATCH {transport.N_DISPATCH}; host "
          f"{host_total:.3f} s, lanes {lanes_total:.3f} s, lanes "
          f"parse+fold+pack {host_half:.3f} s, pack {pack_bytes} B; with "
          f"these constants auto takes the device path from {cross} of SAM")

    out, err, total, counts = cli_run(ctx, ["polish", fasta, *sams])
    check(out == host_runs["ecoli50x"][0], "auto: FASTA != host FASTA")
    if choice == "host":
        check(no_launches(counts) and "note: GPU attached" in err,
              f"auto predicted host but launched {counts}")
    else:
        check(counts["lanes_vote_packed4"] == 1,
              f"auto predicted device but launched {counts}")
    print(f"polish with no --backend: took {choice} as predicted, total "
          f"{total:.3f} s, launches {counts}; FASTA == host")

    for case in ("ecoli50x", "repeats"):
        fasta, sams = cases[case]
        dbg = os.path.join(DATA_DIR, f"{case}_debug.tsv")
        runs = {}
        for label, flags in (("host", ["--backend", "host"]),
                             ("pod", ["--pod-shards", "4"])):
            out, err, total, counts = cli_run(
                ctx, ["polish", *flags, "--debug", dbg, fasta, *sams])
            check(no_launches(counts), f"{case} {label}: launches {counts}")
            runs[label] = (out, file_digest(dbg),
                           re.sub(r"Pod mode: [^\n]*\n\n", "", err))
            print(f"polish {' '.join(flags)} --debug {case}: total "
                  f"{total:.3f} s, debug TSV {os.path.getsize(dbg)} B")
            os.remove(dbg)
        check(runs["pod"] == runs["host"],
              f"{case}: --pod-shards 4 != host (FASTA, TSV or stderr)")
        print(f"--pod-shards 4 {case}: FASTA, --debug TSV and stderr (but "
              f"the Pod mode line) == host")
    print(f"phase 12 (auto and pod shards): {time.monotonic() - t0:.1f} s")


# -- phase 13 ---------------------------------------------------------

RANK_TIMEOUT_S = 300
# one rank of a process group: the port's CLI, each kernel call of its
# models held against the plain version on the same tensors, then its
# launch counters, the lane packs it made, the largest difference from
# plain and whether it left its group, on stderr
RANK_LAUNCHER = r"""
import json, sys, time
import torch.distributed as dist
from polypolish_tpu_torch import cli
from polypolish_tpu_torch.models import polisher
from polypolish_tpu_torch.native import runs
from polypolish_tpu_torch.ops import vote_chunks, vote_lanes

packs = {"packs": 0, "with_overflow": 0}
max_abs_err = {"lanes_vote_packed4": 0, "chunk_vote": 0, "overflow_vote": 0}
lanes = runs.ParsedRuns.lanes


def counted(self, *args, **kwargs):
    pack = lanes(self, *args, **kwargs)
    if pack is not None:
        packs["packs"] += 1
        packs["with_overflow"] += int(pack.n_overflow > 0)
    return pack


def held(entry, fn, plain, in_place=False):
    def call(*args, **kwargs):
        # an in-place wrapper's plain version adds onto its own copy
        plain_args = (args[0].clone(),) + args[1:] if in_place else args
        got = fn(*args, **kwargs)
        want = plain(*plain_args)
        if got.shape != want.shape:
            raise AssertionError(f"{entry}: {tuple(got.shape)} != plain "
                                 f"{tuple(want.shape)}")
        if got.numel():
            err = int((got.long() - want.long()).abs().max())
            max_abs_err[entry] = max(max_abs_err[entry], err)
        return got
    return call


runs.ParsedRuns.lanes = counted
polisher.lanes_counts = held("lanes_vote_packed4", polisher.lanes_counts,
                             vote_lanes.lanes_counts_plain)
polisher.chunk_counts = held("chunk_vote", polisher.chunk_counts,
                             vote_chunks.chunk_counts_plain)
polisher.overflow_counts = held("overflow_vote", polisher.overflow_counts,
                                vote_lanes.add_overflow_counts, True)
t0 = time.monotonic()
rc = cli.main(sys.argv[1:])
print("RANK " + json.dumps(dict(
    rc=rc, wall_s=time.monotonic() - t0, left_group=not dist.is_initialized(),
    lanes=dict(vote_lanes.lanes_counts.launches),
    chunk_vote=vote_chunks.chunk_counts.launches,
    overflow_vote=vote_lanes.overflow_counts.launches,
    max_abs_err=max_abs_err, **packs)), file=sys.stderr)
sys.exit(rc)
"""
GLOO_LINE = re.compile(r"^\[[WIE]\d{4} [^\]]*\] \[c10d\].*\n?", re.M)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argvs, envs):
    """Start one RANK_LAUNCHER process per (argv, environment) at once;
    returns
    [(stdout, stderr without the RANK line, RANK dict)].  Every process
    is killed if any outlives RANK_TIMEOUT_S."""
    procs = [subprocess.Popen([sys.executable, "-c", RANK_LAUNCHER, *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=HERE)
             for argv, env in zip(argvs, envs)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            check(p.returncode == 0,
                  f"rank exit code {p.returncode}\n{err[-4000:]}")
            lines = err.splitlines(keepends=True)
            rank = [ln for ln in lines if ln.startswith("RANK ")]
            check(len(rank) == 1, f"rank printed no RANK line\n{err[-4000:]}")
            results.append((out, "".join(ln for ln in lines
                                         if not ln.startswith("RANK ")),
                            json.loads(rank[0][5:])))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def check_rank_launches(ctx, label, info):
    """A rank launched kernel A once per lane pack it made, the overflow
    kernel once per pack with cap-overflow events, nothing else, and
    every call equalled its plain version on the same tensors; adds the
    launches and the differences to the kernels line's."""
    want = {"lanes": {"lanes_vote_packed4": info["packs"]},
            "overflow_vote": info["with_overflow"], "chunk_vote": 0}
    got = {"lanes": {k: v for k, v in info["lanes"].items() if v},
           "overflow_vote": info["overflow_vote"],
           "chunk_vote": info["chunk_vote"]}
    check(got == want and info["packs"] > 0 and info["left_group"],
          f"{label}: launches {got}, want {want}; left its group "
          f"{info['left_group']}")
    check(not any(info["max_abs_err"].values()),
          f"{label}: a kernel call != plain (max err {info['max_abs_err']})")
    for k, n in info["lanes"].items():
        ctx["launches"][k] += n
    for k in ("overflow_vote", "chunk_vote"):
        ctx["launches"][k] += info[k]
    for k, err in info["max_abs_err"].items():
        ctx["errs"][k] = max(ctx["errs"][k], err)


def last_block(vb: torch.Tensor, rows_per_block: int) -> int:
    """Blocks of a packed4 cell up to its last one holding a vote (the
    pack pads every cell to one block count)."""
    full = (vb != -1).view(-1, rows_per_block * vb.shape[1]).any(dim=1)
    idx = torch.nonzero(full)
    return int(idx.max()) + 1 if idx.numel() else 0


def time_kernel_a(vb, bt, n_tiles, r_sub, tile_w):
    """(ms, plain ms, torch.bincount ms, votes, bytes) of kernel A alone
    on one pack, as phase 6 times it."""
    from polypolish_tpu_torch.ops import vote_lanes

    starts = torch.from_numpy(vote_lanes.tile_row_start(
        bt.cpu().numpy(), n_tiles, r_sub // 4)).to(vb.device)
    out = torch.empty((8, n_tiles * tile_w), dtype=torch.int32,
                      device=vb.device)
    fn = vote_lanes._kernel().lanes_vote_packed4
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(fn(vb.data_ptr(), starts.data_ptr(), out.data_ptr(), n_tiles,
                 tile_w, stream) == 0, "lanes_vote_packed4 launch")

    ms = cuda_ms(run, TIMED_LAUNCHES)
    plain = cuda_ms(lambda: vote_lanes.lanes_counts_plain(
        vb, bt, n_tiles, r_sub, tile_w), 3)
    keys = lanes_keys(vb, bt, n_tiles, r_sub, tile_w, "packed4")
    lib = cuda_ms(lambda: torch.bincount(keys, minlength=8 * n_tiles
                                         * tile_w), 3)
    n_bytes = vb.numel() * 4 + bt.numel() * 4 + 8 * n_tiles * tile_w * 4
    return ms, plain, lib, int(keys.numel()), n_bytes


def phase_sharded_pod(ctx, cases, host_runs):
    """Phase 13: --backend sharded on grids of cuda:0, two gloo ranks
    with device votes, and batch --shard-across-hosts.  Returns kernel
    A's timing on the uncapped 1x1 E. coli mesh pack."""
    from polypolish_tpu_torch.ops.vote_lanes import R_SUB, TILE_W
    from polypolish_tpu_torch.parallel import make_mesh
    from polypolish_tpu_torch.utils.profiling import StageTimer

    t0 = time.monotonic()
    dev = ctx["dev"]
    uncapped = None
    for case, grid in (("ecoli50x", (1, 1)), ("ecoli50x", (2, 2)),
                       ("repeats", (2, 1)), ("repeats", (1, 2))):
        label = f"sharded {case} {grid[0]}x{grid[1]}"
        n_cells = grid[0] * grid[1]
        mesh = make_mesh(*grid, devices=[dev] * n_cells)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with capture_calls(lanes_counts=True, overflow_counts=True,
                           chunk_counts=True) as calls:
            fasta_out, err, total, counts, timer = polish_run(
                ctx, *cases[case], StageTimer(sync_device=dev),
                backend="sharded", mesh=mesh, kernel_variant="lanes")
        peak = torch.cuda.max_memory_allocated()
        check(fasta_out == host_runs[case][0], f"{label}: FASTA != host")
        check(err == host_runs[case][1], f"{label}: stderr != host")
        want = {k: 0 for k in ctx["kernels"]}
        want["lanes_vote_packed4"] = n_cells
        check(counts == want, f"{label}: launches {counts}, want {want}")
        cells = [args for args, _ in calls["lanes_counts"]]
        check(len(cells) == n_cells and not calls["chunk_counts"]
              and not calls["overflow_counts"],
              f"{label}: {len(cells)} kernel A calls captured")
        pack_bytes = sum(a[0].numel() * 4 + a[1].numel() * 4 for a in cells)
        deepest = max(last_block(a[0], R_SUB // 4) for a in cells)
        print(f"{label}: total {total:.3f} s | {fmt_stages(timer.seconds)} "
              f"| launches {counts} | mesh pack {pack_bytes} B, "
              f"{cells[0][1].numel()} blocks per cell (deepest cell's last "
              f"voting block {deepest}), {cells[0][2]} tiles per cell | "
              f"peak device memory {peak} B, {peak - held} B above the "
              f"{held} B held")
        check_captured(ctx, label, calls)
        if uncapped is None:
            uncapped = time_kernel_a(*cells[0][:3], R_SUB, TILE_W)
            ms, plain, lib, votes, n_bytes = uncapped
            b_ms, b_by = bound(n_bytes, votes)
            print(f"lanes_vote_packed4 on the {label} mesh pack (no cap): "
                  f"{ms:.4f} ms for {votes} votes, {n_bytes} B; plain "
                  f"{plain:.3f} ms; torch.bincount {lib:.3f} ms; bound "
                  f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)")
        del calls, cells
    print(f"sharded: FASTA and stderr == host on every grid")

    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share a host
    fasta, sams = cases["ecoli50x"]
    port = free_port()
    t1 = time.monotonic()
    ranks = run_ranks(
        [["polish", "--distributed", "--coordinator", f"127.0.0.1:{port}",
          "--num-processes", "2", "--process-id", str(r), "--device",
          dev.type, fasta, *sams]
         for r in range(2)],
        [dict(env, POLYPOLISH_TPU_POD_DEVICE_VOTES="1")] * 2)
    total = time.monotonic() - t1
    check(ranks[0][0] == host_runs["ecoli50x"][0],
          "pod rank 0: FASTA != host FASTA")
    check(ranks[1][0] == "", "pod rank 1 wrote to stdout")
    err0 = re.sub(r"Pod mode: [^\n]*\n\n", "",
                  GLOO_LINE.sub("", ranks[0][1]))
    check(_CLOCK.sub("", err0) == host_runs["ecoli50x"][1],
          "pod rank 0: stderr != host stderr (but the Pod mode line)")
    check(GLOO_LINE.sub("", ranks[1][1]) == "",
          "pod rank 1 wrote a narrative")
    for r, (_, _, info) in enumerate(ranks):
        check_rank_launches(ctx, f"pod rank {r}", info)
        print(f"pod rank {r} (device votes, cuda:0): wall {info['wall_s']:.3f}"
              f" s | launches {info['lanes']} + overflow_vote "
              f"{info['overflow_vote']} + chunk_vote {info['chunk_vote']} "
              f"| packs {info['packs']}, with overflow "
              f"{info['with_overflow']} | max abs err vs plain "
              f"{info['max_abs_err']} | left its group")
    print(f"pod: two gloo ranks on cuda:0, {total:.3f} s; rank 0 FASTA and "
          f"stderr == host")

    genomes = ("ecoli50x", "repeats", "repeats16")
    jobs = [(g, os.path.join(DATA_DIR, f"hosts_{g}_{k}.fasta"))
            for g in genomes for k in (1, 2)]
    manifest = os.path.join(DATA_DIR, "hosts.tsv")
    with open(manifest, "w") as f:
        for g, out_path in jobs:
            f.write(f"{cases[g][0]}\t{out_path}\t{','.join(cases[g][1])}\n")
    port = free_port()
    t1 = time.monotonic()
    ranks = run_ranks(
        [["batch", "--shard-across-hosts", "--backend", "device",
          "--device", dev.type, "--workers", "1", manifest]
         for _ in range(2)],
        [dict(env, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
              JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))
         for r in range(2)])
    total = time.monotonic() - t1
    for r, (_, err, info) in enumerate(ranks):
        check(f"host {r}/2: polishing 3 of 6 genomes" in err
              and "Genomes polished: 3/3" in err, f"batch rank {r}: {err}")
        check(info["packs"] == 3, f"batch rank {r}: {info['packs']} packs")
        check_rank_launches(ctx, f"batch rank {r}", info)
        print(f"batch --shard-across-hosts rank {r}: wall "
              f"{info['wall_s']:.3f} s | launches {info['lanes']} + "
              f"overflow_vote {info['overflow_vote']} + chunk_vote "
              f"{info['chunk_vote']} | max abs err vs plain "
              f"{info['max_abs_err']}")
    for g, out_path in jobs:
        with open(out_path) as f:
            check(f.read() == host_runs[g][0],
                  f"batch --shard-across-hosts: {out_path} != host FASTA")
        os.remove(out_path)
    print(f"batch --shard-across-hosts: two ranks, three genomes each, "
          f"{total:.3f} s; every output == its genome's host FASTA")
    print(f"phase 13 (sharded, pod ranks, batch across hosts): "
          f"{time.monotonic() - t0:.1f} s")
    return uncapped


if __name__ == "__main__":
    sys.exit(main())
