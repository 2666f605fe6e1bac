"""Batch polishing: many genomes through one process (counterpart of
polypolish_tpu/pipeline/batch.py; BASELINE.json config 5, "500
bacterial genomes batch-polished").

Genomes run on a thread pool: the native engine's C++ calls release the
GIL, and the device steps of several genomes share the card (every
kernel launch goes on the current stream; the launch counters are
guarded by one lock, ops/launch_count.py).

Manifest format (TSV, one genome per line):
    assembly.fasta <TAB> polished_out.fasta <TAB> aln1.sam[,aln2.sam...]
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from polypolish_tpu_torch import log
from polypolish_tpu_torch.errors import PolypolishError, quit_with_error
from polypolish_tpu_torch.utils.timing import format_duration


def parse_manifest(path: str) -> List[Tuple[str, str, List[str]]]:
    jobs = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) != 3:
                quit_with_error(
                    f"manifest line {line_no} must have 3 tab-separated "
                    "fields: assembly, output, comma-joined SAMs"
                )
            assembly, out_path, sams = parts
            jobs.append((assembly, out_path, sams.split(",")))
    if not jobs:
        quit_with_error(f'no jobs found in manifest "{path}"')
    return jobs


def polish_batch(
    jobs: Sequence[Tuple[str, str, List[str]]],
    fraction_invalid: float = 0.2,
    fraction_valid: float = 0.5,
    max_errors: int = 10,
    min_depth: int = 5,
    careful: bool = False,
    backend: str = "device",
    use_native: bool = True,
    workers: Optional[int] = None,
    resume: bool = False,
    n_threads: Optional[int] = None,
    device="cuda",
    kernel_variant: Optional[str] = None,
    shard_across_hosts: bool = False,
) -> List[Dict]:
    """Polish every (assembly, out_path, sams) job; returns per-genome
    summaries [{'assembly', 'out', 'lengths' | 'error' | 'skipped'}].
    ``backend``, ``device``, ``kernel_variant`` and ``use_native`` go to
    each genome's polish().

    With resume=True, jobs whose output already exists and is newer than
    all of its inputs are skipped (per-genome checkpointing; the
    reference has no resume, SURVEY.md section 5).

    With shard_across_hosts=True each process of the process group
    (parallel.multihost.initialize_distributed, called first) takes the
    round-robin slice ``jobs[rank::world]``: genomes are independent, so
    job-level data parallelism across processes needs no collective.
    Without a group the one process takes every job."""
    from polypolish_tpu_torch.pipeline.polish import polish

    start = time.monotonic()
    total_jobs = len(jobs)
    if shard_across_hosts:
        from polypolish_tpu_torch.parallel.multihost import (
            process_count,
            process_index,
        )

        pidx, pcount = process_index(), process_count()
        jobs = list(jobs)[pidx::pcount]
        log.eprint(
            f"host {pidx}/{pcount}: polishing {len(jobs)} of "
            f"{total_jobs} genomes"
        )
        if not jobs:
            return []
    if workers is None:
        workers = min(8, os.cpu_count() or 1, max(1, len(jobs)))

    def _is_done(job) -> bool:
        assembly, out_path, sams = job
        try:
            out_mtime = os.path.getmtime(out_path)
            return all(
                out_mtime >= os.path.getmtime(p) for p in [assembly] + sams
            ) and os.path.getsize(out_path) > 0
        except OSError:
            return False

    # With several genomes in flight the cores are already busy, so
    # per-genome parse and fold threads only add contention; one thread
    # per genome when the pool gives the parallelism.  An explicit
    # n_threads (the batch --threads flag) overrides this.
    if n_threads is not None:
        per_genome_threads: Optional[int] = n_threads
    else:
        per_genome_threads = (
            1 if (workers or 2) > 1 and len(jobs) > 1 else None
        )

    def run_one(job):
        assembly, out_path, sams = job
        if resume and _is_done(job):
            return {"assembly": assembly, "out": out_path, "skipped": True}
        try:
            with open(out_path, "w") as out:
                lengths = polish(
                    None, fraction_invalid, fraction_valid, max_errors,
                    min_depth, careful, assembly, sams,
                    out=out, backend=backend, use_native=use_native,
                    n_threads=per_genome_threads, device=device,
                    kernel_variant=kernel_variant,
                )
            return {"assembly": assembly, "out": out_path, "lengths": lengths}
        except PolypolishError as e:
            return {"assembly": assembly, "out": out_path, "error": str(e)}

    print_log = log.eprint  # capture before quieting
    results: List[Dict] = []
    with log.quiet():
        if workers <= 1 or len(jobs) == 1:
            results = [run_one(j) for j in jobs]
        else:
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                results = list(pool.map(run_one, jobs))

    ok = sum(1 for r in results if "error" not in r)
    skipped = sum(1 for r in results if r.get("skipped"))
    failed = [r for r in results if "error" in r]
    log.section_header("Batch polishing finished")
    print_log(f"Genomes polished: {ok}/{len(jobs)} "
              f"(workers={workers}, backend={backend}"
              + (f", {skipped} resumed/skipped" if skipped else "") + ")")
    for r in failed:
        print_log(f"  FAILED {r['assembly']}: {r['error']}")
    print_log(f"Time to run: {format_duration(time.monotonic() - start)}")
    return results
