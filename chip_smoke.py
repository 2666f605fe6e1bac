#!/usr/bin/env python3
"""Smoke run of polypolish_tpu_torch (the PyTorch/CUDA port) on one
NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, in order; any failure raises and exits non-zero:

1. Print the card (nvidia-smi name, power limit).  Build the native C++
   engine (g++) and both CUDA kernels (one nvcc per source, in
   parallel) from the sources in the checkout, while the workloads are
   generated: benchmarks/workload.py's 4.6 Mb E. coli-shaped draft with
   paired 150 bp reads at 50x (two SAM files), and its repeat-rich
   variant (a 5 kb segment in 8 copies).
2. The lanes vote kernel against its plain PyTorch version on the card,
   bitwise: the E. coli pack, a skewed pack with a tile deeper than 255
   byte-rows, and a stream rounded to a 32,768-block slab multiple.
3. The chunk vote kernel against its plain version, bitwise, in both
   pad layouts: the E. coli cap-overflow chunks (int32, pos -1) and the
   E. coli events in the native uint8 chunk layout (vocab 255).
4. End to end: ``polish`` with backend="device" on the card for both
   workloads, each FASTA byte-identical to the port's backend="host"
   run and each stderr identical with the clock masked; the kernels'
   launch counters, zeroed just before, must be non-zero just after.
   Per-stage times and the total are printed.
5. Kernel and plain-version times with CUDA events, one PyTorch
   library call on the same inputs as a yardstick (torch.bincount), and
   the least time the card could take (bytes over 3.35 TB/s).  Then the
   ``kernels`` JSON line and, last, the device JSON line.

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
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# int32 add/logic issue rate of the H100 SXM's CUDA cores: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost (Hopper architecture white paper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, "build", "chip_smoke")


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
    from polypolish_tpu_torch.io.fasta import load_fasta
    from polypolish_tpu_torch.native import runs
    from polypolish_tpu_torch.vocab import Vocab

    fa = load_fasta(fasta)
    names = [n for n, _, _ in fa]
    lens = {n: len(s) for n, _, s in fa}
    return runs.parse_runs(sams, names, lens, Vocab(), 10, False), names[0], lens[names[0]]


def lanes_keys(vb: torch.Tensor, block_tile: torch.Tensor, n_tiles: int,
               r_sub: int, tile_w: int) -> torch.Tensor:
    """Flattened (v * width + position) keys of every dense byte of a
    packed4 pack — the input of the torch.bincount yardstick."""
    width = n_tiles * tile_w
    rows = block_tile.to(torch.int64).repeat_interleave(r_sub // 4) * tile_w
    cols = torch.arange(tile_w, device=vb.device)
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int32, device=vb.device)
    parts = []
    step = (1 << 22) // tile_w
    for r0 in range(0, vb.shape[0], step):
        b = (vb[r0:r0 + step, :, None] >> shifts) & 0xFF
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
    from polypolish_tpu_torch.ops import vote_chunks, vote_lanes
    from polypolish_tpu_torch.pipeline.polish import _pad_bucket, polish
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
    print(f"phase 1 (builds + workloads): {time.monotonic() - t0:.1f} s")

    R_SUB, TILE_W = vote_lanes.R_SUB, vote_lanes.TILE_W
    errs = {"lanes": 0, "chunks": 0}

    # -- phase 2: lanes vote kernel vs plain --------------------------
    t0 = time.monotonic()
    fasta, sams = cases["ecoli50x"]
    pr, name, P = parse(fasta, sams)
    p_pad = _pad_bucket(P)
    pack = pr.lanes(name, R_SUB, TILE_W, num_positions=p_pad, packed4=True,
                    cap=True)
    check(pack is not None, "E. coli lane pack")
    try:
        # copies: the pack's arrays alias native memory that close() frees
        e_vb = torch.from_numpy(pack.vb).to(dev, copy=True)
        e_bt = torch.from_numpy(pack.block_tile).to(dev, copy=True)
        e_ntiles = pack.n_tiles
        ov_pos = pack.ov_pos.astype(np.int64)
        ov_vid = pack.ov_vid.astype(np.int32)
        print(f"E. coli pack: P={P} p_pad={p_pad} n_blocks={pack.n_blocks} "
              f"vb={pack.vb.nbytes} B events={pack.n_events} "
              f"overflow={pack.n_overflow}")
    finally:
        pack.close()

    def check_lanes(label, vb, bt, n_tiles, r_sub, tile_w):
        got = vote_lanes.lanes_counts(vb, bt, n_tiles, r_sub, tile_w)
        want = vote_lanes.lanes_counts_plain(vb, bt, n_tiles, r_sub, tile_w)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"lanes kernel != plain on {label} (max err {err})")
        errs["lanes"] = max(errs["lanes"], err)
        print(f"lanes kernel == plain on {label}: {tuple(vb.shape)} int32, "
              f"{n_tiles} tiles, {int(want.sum())} votes")
        return got

    e_counts = check_lanes("E. coli pack", e_vb, e_bt, e_ntiles, R_SUB,
                           TILE_W)

    # skewed pack: a hot spot ~2,000 deep puts one tile far past 255
    # byte-rows (the kernel's packed-plane flush boundary)
    rng = np.random.default_rng(1)
    n_sk, p_sk = 3_000_000, 200_000
    pos = np.concatenate([rng.integers(0, p_sk, n_sk - 40_000),
                          rng.integers(5000, 5020, 40_000)])
    voc = rng.integers(0, 8, pos.size)
    voc[rng.random(pos.size) < 0.02] = 200  # sparse tier -> pad byte
    vb_u8, bt, n_tiles = vote_lanes.prepare_lanes(pos, voc, p_sk)
    deepest = int((bt == 5000 // TILE_W).sum()) * R_SUB
    check(deepest > 255, f"skewed pack deepest tile {deepest} byte-rows")
    check_lanes(f"skewed pack (deepest tile {deepest} byte-rows)",
                torch.from_numpy(vote_lanes.to_packed4(vb_u8, R_SUB)).to(dev),
                torch.from_numpy(bt).to(dev), n_tiles, R_SUB, TILE_W)

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
    print(f"phase 2 (lanes kernel): {time.monotonic() - t0:.1f} s")

    # -- phase 3: chunk vote kernel vs plain --------------------------
    t0 = time.monotonic()

    def check_chunks(label, cp, cv, ct, n_tiles):
        got = vote_chunks.chunk_counts(cp, cv, ct, n_tiles)
        want = vote_chunks.chunk_counts_plain(cp, cv, ct, n_tiles)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        check(err == 0, f"chunk kernel != plain on {label} (max err {err})")
        errs["chunks"] = max(errs["chunks"], err)
        print(f"chunk kernel == plain on {label}: {ct.shape[0]} chunks "
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
    u_counts = check_chunks("E. coli events (uint8, pad vocab 255)",
                            u_cp, u_cv, u_ct, u8[3])
    # both layouts add up to the same pileup: lanes + overflow == chunks
    full = e_counts + vote_chunks.chunk_counts_plain(o_cp, o_cv, o_ct,
                                                     ov_tiles)[:, :p_pad]
    check(torch.equal(full, u_counts[:, :p_pad]),
          "lanes + overflow counts != uint8 chunk counts")
    del u_cp, u_cv, u_ct, u8, u_counts, full
    pr.close()
    print(f"phase 3 (chunk kernel): {time.monotonic() - t0:.1f} s")

    # -- phase 4: end to end ------------------------------------------
    launches = {}
    for case, (fasta, sams) in cases.items():
        runs = {}
        for backend in ("device", "host"):
            timer = StageTimer(sync_device=dev if backend == "device"
                               else None)
            out, err = io.StringIO(), io.StringIO()
            vote_lanes.lanes_counts.launches = 0
            vote_chunks.chunk_counts.launches = 0
            t0 = time.monotonic()
            with contextlib.redirect_stderr(err):
                lengths = polish(None, 0.2, 0.5, 10, 5, False, fasta, sams,
                                 out=out, backend=backend, device="cuda",
                                 timer=timer)
            total = time.monotonic() - t0
            counts = (vote_lanes.lanes_counts.launches,
                      vote_chunks.chunk_counts.launches)
            runs[backend] = (out.getvalue(), _CLOCK.sub("", err.getvalue()))
            stages = " ".join(f"{k} {v:.3f}"
                              for k, v in timer.seconds.items())
            print(f"e2e {case} backend={backend}: total {total:.3f} s | "
                  f"{stages} | launches lanes={counts[0]} "
                  f"chunks={counts[1]} | lengths {lengths}")
            if backend == "device":
                check(counts[0] > 0 and counts[1] > 0,
                      f"{case}: kernels not launched on the main path "
                      f"{counts}")
                for k, n in zip(("lanes", "chunks"), counts):
                    launches[k] = launches.get(k, 0) + n
        check(runs["device"][0] == runs["host"][0],
              f"{case}: device FASTA != host FASTA")
        check(runs["device"][1] == runs["host"][1],
              f"{case}: device stderr != host stderr")
        fasta_out = runs["device"][0]
        check(fasta_out.startswith(">") and fasta_out.count("\n") == 2,
              f"{case}: malformed FASTA")
        print(f"e2e {case}: device FASTA == host FASTA "
              f"({len(fasta_out)} bytes), stderr equal")
    print(f"peak device memory {torch.cuda.max_memory_allocated()} B")

    # -- phase 5: timings ---------------------------------------------
    lib_a = vote_lanes._kernel()
    starts = torch.from_numpy(vote_lanes.tile_row_start(
        e_bt.cpu().numpy(), e_ntiles, R_SUB // 4)).to(dev)
    out_a = torch.empty_like(e_counts)
    stream = torch.cuda.current_stream().cuda_stream

    def run_a():
        check(lib_a.lanes_vote_packed4(e_vb.data_ptr(), starts.data_ptr(),
                                       out_a.data_ptr(), e_ntiles, TILE_W,
                                       stream) == 0, "lanes launch")

    lib_b = vote_chunks._kernel()
    out_b = torch.zeros((8, ov_tiles * 256), dtype=torch.int32, device=dev)

    def run_b():  # the zero-fill is part of producing the output
        out_b.zero_()
        check(lib_b.chunk_vote_i32(o_cp.data_ptr(), o_cv.data_ptr(),
                                   o_ct.data_ptr(), o_ct.shape[0],
                                   out_b.data_ptr(), ov_tiles, stream) == 0,
              "chunk launch")

    a_ms = cuda_ms(run_a, 50)
    a_plain = cuda_ms(lambda: vote_lanes.lanes_counts_plain(
        e_vb, e_bt, e_ntiles, R_SUB, TILE_W), 3)
    keys_a = lanes_keys(e_vb, e_bt, e_ntiles, R_SUB, TILE_W)
    a_lib = cuda_ms(lambda: torch.bincount(
        keys_a, minlength=8 * e_ntiles * TILE_W), 3)
    a_votes = int(keys_a.numel())
    del keys_a
    b_ms = cuda_ms(run_b, 50)
    b_plain = cuda_ms(lambda: vote_chunks.chunk_counts_plain(
        o_cp, o_cv, o_ct, ov_tiles), 5)
    keys_b = chunk_keys(o_cp, o_cv, o_ct, ov_tiles)
    b_lib = cuda_ms(lambda: torch.bincount(
        keys_b, minlength=8 * ov_tiles * 256), 5)
    b_votes = int(keys_b.numel())

    a_bytes = (e_vb.numel() * 4 + e_bt.numel() * 4
               + 8 * e_ntiles * TILE_W * 4)
    b_bytes = (o_cp.numel() * 4 + o_cv.numel() * 4 + o_ct.numel() * 4
               + 8 * ov_tiles * 256 * 4)
    a_bound, a_by = bound(a_bytes, a_votes)
    b_bound, b_by = bound(b_bytes, b_votes)
    print(f"lanes kernel: {a_ms:.4f} ms for {a_votes} votes "
          f"({a_votes / a_ms / 1e6:.2f} G votes/s), {a_bytes} B moved, "
          f"{a_bytes / a_ms / 1e9:.3f} TB/s; plain {a_plain:.3f} ms; "
          f"torch.bincount {a_lib:.3f} ms; bound {a_bound:.4f} ms "
          f"({a_bound / a_ms:.1%} of it)")
    print(f"chunk kernel: {b_ms:.4f} ms for {b_votes} votes in "
          f"{o_ct.shape[0]} chunks, {b_bytes} B moved, "
          f"{b_bytes / b_ms / 1e9:.3f} TB/s; plain {b_plain:.3f} ms; "
          f"torch.bincount {b_lib:.3f} ms; bound {b_bound:.4f} ms "
          f"({b_bound / b_ms:.1%} of it)")

    kernels = [
        {"name": "lanes_vote_packed4", "route": "cuda",
         "source": "polypolish_tpu_torch/csrc/lanes_vote.cu",
         "replaces": "polypolish_tpu/ops/vote_lanes.py:143",
         "launches": launches["lanes"], "max_abs_err": errs["lanes"],
         "ms": a_ms, "plain_ms": a_plain, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": a_lib},
        {"name": "chunk_vote", "route": "cuda",
         "source": "polypolish_tpu_torch/csrc/chunk_vote.cu",
         "replaces": "polypolish_tpu/ops/vote_pallas.py:144",
         "launches": launches["chunks"], "max_abs_err": errs["chunks"],
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": b_lib},
    ]
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    print(f"chip_smoke total {time.monotonic() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
