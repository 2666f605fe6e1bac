"""The lanes path's cap-overflow fold in two trees of the port, on one
card: this repository's and another checkout of it (an earlier commit's,
unpacked with ``git archive`` into a gitignored directory).

    python3 tools/overflow_fold_ab.py --other NAME=path/to/tree [--reps 2]

benchmarks/workload.py writes three workloads once, under
build/overflow_ab/, from seed 0 (paired 150 bp reads at 50x): the
4.6 Mb E. coli-shaped draft, its repeat-rich variant (a 5 kb segment in
8 copies) and one 33.6 Mb contig, which ``polish`` takes through its
windowed device twin at the default 8 Mb windows.  Each tree then runs
in its own process (the tree's root on sys.path), in turns: other,
this, this, other for --reps 2.  A process builds the tree's kernels,
polishes E. coli once to warm up, then each workload with backend
"device" (the lanes path) and a synchronising stage timer, the peak
device memory reset before each.  It prints one JSON line per
workload: the tree, stage seconds (``kernel_b`` is the overflow fold,
summed over the windows), the total, the peak device memory and a
digest of the FASTA, which must be the same in every run.  Prints the
card line first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(HERE, "build", "overflow_ab")
BIG_LEN = 33_600_000

CHILD = r"""
import contextlib, hashlib, io, json, sys, time
import torch
from polypolish_tpu_torch import _build
from polypolish_tpu_torch.pipeline.polish import polish
from polypolish_tpu_torch.utils.profiling import StageTimer

tree, cases = sys.argv[1], json.loads(sys.argv[2])
dev = torch.device("cuda")
_build.build_all()


def run(fasta, sams):
    timer = StageTimer(sync_device=dev)
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(io.StringIO()):
        polish(None, 0.2, 0.5, 10, 5, False, fasta, sams, out=out,
               device=dev, timer=timer, backend="device")
    torch.cuda.synchronize()
    total = time.monotonic() - t0
    return (total, dict(timer.seconds), torch.cuda.max_memory_allocated(),
            hashlib.sha256(out.getvalue().encode()).hexdigest()[:16])


run(*cases["ecoli50x"])  # warm-up: CUDA context, first launches
for name, (fasta, sams) in cases.items():
    total, stages, peak, digest = run(fasta, sams)
    print("AB " + json.dumps(dict(tree=tree, case=name, total_s=total,
                                  stages=stages, peak_bytes=peak,
                                  fasta=digest)), flush=True)
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def workloads():
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    import workload

    cases = {}
    for name, kwargs in (("ecoli50x", {}),
                         ("repeats", dict(repeat_len=5000, repeat_copies=8)),
                         ("contig33m", dict(genome_len=BIG_LEN,
                                            coverage=50.0))):
        fasta, sams, _ = workload.make_paired_case(seed=0, **kwargs)
        cases[name] = workload.write_case(DATA_DIR, name, fasta, sams)
        del fasta, sams
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="NAME=path of the other tree's root")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    other_name, other_root = args.other.split("=", 1)
    trees = {"this": HERE, other_name: os.path.abspath(other_root)}
    print(card_line(), flush=True)
    t0 = time.monotonic()
    cases = workloads()
    print(f"workloads written in {time.monotonic() - t0:.1f} s", flush=True)
    order = []
    for k in range(args.reps):
        pair = [other_name, "this"]
        order += pair if k % 2 == 0 else pair[::-1]
    env = dict(os.environ)
    digests = {}
    for name in order:
        env["PYTHONPATH"] = trees[name]
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, name, json.dumps(cases)],
            cwd=trees[name], env=env, capture_output=True, text=True,
            timeout=1200)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("AB "):
                rec = json.loads(line[3:])
                digests.setdefault(rec["case"], set()).add(rec["fasta"])
                print(line[3:], flush=True)
    bad = {k: v for k, v in digests.items() if len(v) != 1}
    for case in list(cases):
        for path in [cases[case][0], *cases[case][1]]:
            os.remove(path)
    if bad:
        print(f"FASTA differs between runs: {bad}", file=sys.stderr)
        return 1
    print(f"every run's FASTA equal per workload; "
          f"{time.monotonic() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
