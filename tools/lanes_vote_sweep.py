"""Time builds of the lanes vote kernel (csrc/lanes_vote.cu) against one
another on the card: the repo's source and any other copy of it (an
earlier commit's, or one with another segment length or batch), on packs
of the shapes the main path gives it.

    python3 tools/lanes_vote_sweep.py [--extra NAME=path/to/lanes_vote.cu
        ...] [--reps 50]

Each build is one nvcc for sm_90a, all started together, into
polypolish_tpu_torch/csrc/build/sweep/ ("repo" is the repo's source).
Packs, from seed 0 (kernel time does not depend on the vote values, only
on rows and pad): "capped" is 2,304 tiles of 2,048 columns with 1-3
blocks of 32 byte-rows each and 8 on the last tile (4,608 blocks in all,
the capped E. coli pack's shape); "padded" adds 512 all-pad blocks on
the last tile (geom_pad(4,609) = 5,120); "mesh" has 5,937 blocks and 207
pad blocks on the last tile (the uncapped 1x1 mesh pack's shape).  Every
build is held bitwise against lanes_counts_plain on every pack, then
timed with CUDA events in turns (builds in order, then in reverse), with
chip_smoke.py's timer and bound.  Prints the card line and one line per
(build, entry point, pack).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import bound, card_line, cuda_ms  # noqa: E402
from polypolish_tpu_torch import _build  # noqa: E402
from polypolish_tpu_torch.ops import vote_lanes  # noqa: E402

N_TILES, TILE_W, R_SUB = 2304, 2048, vote_lanes.R_SUB


def build(sources):
    """{name: ctypes library} of each (name, source), one nvcc each, all
    at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, source in sources:
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, source, "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        text = proc.communicate(timeout=600)[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
        cdll = ctypes.CDLL(lib)
        for entry in ("lanes_vote_packed4", "lanes_vote_bytes"):
            fn = getattr(cdll, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def packs(dev):
    """{name: (byte rows uint8 on dev, block_tile on dev)}."""
    rng = np.random.default_rng(0)
    per_tile = np.full(N_TILES, 2)
    order = rng.permutation(N_TILES - 1)
    per_tile[order[:603]] = 1
    per_tile[order[603:1200]] = 3
    per_tile[-1] = 8  # the capped E. coli pack's last tile: 64 int32 rows
    mesh = per_tile.copy()
    mesh[:5937 - 4608] += 1
    out = {}
    for name, counts, pad in (("capped", per_tile, 0),
                              ("padded", per_tile, 512),
                              ("mesh", mesh, 207)):
        bt = np.repeat(np.arange(N_TILES, dtype=np.int32), counts)
        bt = np.concatenate([bt, np.full(pad, N_TILES - 1, np.int32)])
        n_real = int(counts.sum()) * R_SUB
        vb = torch.randint(0, 8, (bt.size * R_SUB, TILE_W), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
        vb[torch.rand(vb.shape, device=dev) < 0.25] = 255
        vb[n_real:] = 255
        out[name] = (vb, torch.from_numpy(bt).to(dev))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=SOURCE")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(card_line())
    libs = build([("repo", os.path.join(_build.CSRC, "lanes_vote.cu"))]
                 + [tuple(e.split("=", 1)) for e in args.extra])
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for pname, (vb_u8, bt) in packs(dev).items():
        for entry, body, vb in (
                ("lanes_vote_packed4", "packed4", vb_u8.view(-1, 4, TILE_W)
                 .transpose(1, 2).contiguous().view(torch.int32)
                 .view(-1, TILE_W)),
                ("lanes_vote_bytes", "packed", vb_u8)):
            rpb = vote_lanes._rows_per_block(R_SUB, body)
            starts = torch.from_numpy(vote_lanes.tile_row_start(
                bt.cpu().numpy(), N_TILES, rpb)).to(dev)
            want = vote_lanes.lanes_counts_plain(vb, bt, N_TILES, R_SUB,
                                                 TILE_W, body)
            n_bytes = (vb.numel() * vb.element_size() + bt.numel() * 4
                       + want.numel() * 4)
            votes = int(want.sum())
            cases.append((pname, entry, vb, starts, want,
                          bound(n_bytes, votes)[0]))
    out = torch.empty((8, N_TILES * TILE_W), dtype=torch.int32, device=dev)
    times = {}
    for name, lib in libs.items():
        for pname, entry, vb, starts, want, _ in cases:
            out.fill_(-7)
            fn = getattr(lib, entry)
            assert fn(vb.data_ptr(), starts.data_ptr(), out.data_ptr(),
                      N_TILES, TILE_W, stream) == 0
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} {entry} != plain on {pname}")
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for pname, entry, vb, starts, _, _ in cases:
                fn = getattr(libs[name], entry)
                t = cuda_ms(lambda: fn(vb.data_ptr(), starts.data_ptr(),
                                       out.data_ptr(), N_TILES, TILE_W,
                                       stream), args.reps)
                times.setdefault((name, entry, pname), []).append(t)
    for (name, entry, pname), ts in times.items():
        b_ms = next(c[5] for c in cases if c[0] == pname and c[1] == entry)
        print(f"{name} {entry} {pname}: {' / '.join(f'{t:.4f}' for t in ts)}"
              f" ms; bound {b_ms:.4f} ms ({b_ms / min(ts):.1%} of it)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
