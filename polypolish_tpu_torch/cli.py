"""Command-line interface (counterpart of polypolish_tpu/cli.py;
reference: main.rs:23-126).

The port carries the ``polish``, ``filter``, ``full`` and ``batch``
subcommands:

  python -m polypolish_tpu_torch polish [--debug FILE] [-i 0.2] [-v 0.5]
      [-m 10] [-d 5] [--careful] [--threads N]
      [--backend auto|device|host|xla|sharded] [--kernel-variant lanes|mxu]
      [--pure-python] [--pod-shards N] [--device cuda|cpu]
      [--distributed --coordinator HOST:PORT --num-processes N
       --process-id I]
      assembly sam [sam ...]
  python -m polypolish_tpu_torch filter --in1 .. --in2 .. --out1 ..
      --out2 .. [--orientation auto] [--low 0.1] [--high 99.9]
      [--device cuda|cpu]
  python -m polypolish_tpu_torch full --in1 .. --in2 .. [filter and
      polish options] [--keep-filtered DIR] assembly
  python -m polypolish_tpu_torch batch [polish options] [--workers N]
      [--resume] [--shard-across-hosts] manifest

``--backend auto`` (default) takes the backend that the cost model of
utils/transport.py predicts fastest for the SAM bytes at hand ("host"
when there is no GPU or ``--device cpu``).  ``--backend device`` counts
votes with the port's CUDA kernels on ``--device`` (default cuda; cpu
runs their plain PyTorch versions): the lanes vote kernel
(``--kernel-variant lanes``) or the chunk vote kernel (``mxu``);
``--kernel-variant`` unset reads POLYPOLISH_TPU_KERNEL (else lanes), as
the JAX CLI does.  With ``--pure-python`` the chunk vote kernel counts
the Python reader's event stream.  ``--backend xla`` counts with a
torch scatter-add on ``--device``; ``--backend host`` folds on the
host; ``--backend sharded`` votes over a (data, pos) grid of
``--device``'s visible devices (parallel/shard.py).  ``--pod-shards N``
shards the SAM ingest over N byte ranges and folds on the host;
``--distributed`` runs one process per ingest shard over a gloo
process group (pipeline/pod_distributed.py).  ``filter`` runs its pair
grids of 1 M entries or more as torch ops on ``--device``; ``full``
runs ``filter`` and then ``polish``; ``batch`` polishes the genomes of
a manifest on a thread pool, and with ``--shard-across-hosts`` each
process of a process group takes its slice of the manifest.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from polypolish_tpu_torch import TOOL_NAME, __version__
from polypolish_tpu_torch.errors import PolypolishError, render_error_and_exit


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m polypolish_tpu_torch",
        description=(
            f"{TOOL_NAME} v{__version__}: short-read polishing of long-read "
            "assemblies (PyTorch/CUDA port)"
        ),
    )
    parser.add_argument(
        "--version", action="version", version=f"{TOOL_NAME} v{__version__}"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    f = sub.add_parser(
        "filter", help="filter paired-end alignments based on insert size"
    )
    f.add_argument("--in1", required=True, help="Input SAM file - first read in pairs")
    f.add_argument("--in2", required=True, help="Input SAM file - second read in pairs")
    f.add_argument("--out1", required=True, help="Output SAM file - first read in pairs")
    f.add_argument("--out2", required=True, help="Output SAM file - second read in pairs")
    _add_filter_options(f)
    _add_device_option(f)

    p = sub.add_parser(
        "polish", help="polish a long-read assembly using short-read alignments"
    )
    _add_polish_options(p)
    _add_pod_option(p)
    _add_device_option(p)
    _add_distributed_options(p)
    p.add_argument("assembly", help="Assembly to polish (one file in FASTA format)")
    p.add_argument(
        "sam", nargs="+", help="Short read alignments (one or more files in SAM format)"
    )

    r = sub.add_parser(
        "full",
        help="one-shot paired-end workflow: filter then polish "
        "(the reference's documented two-command pipeline)",
    )
    r.add_argument("--in1", required=True, help="Input SAM - first read in pairs")
    r.add_argument("--in2", required=True, help="Input SAM - second read in pairs")
    _add_filter_options(r)
    _add_polish_options(r)
    _add_device_option(r)
    _add_pod_option(r)
    r.add_argument(
        "--keep-filtered", default=None,
        help="Directory to keep the intermediate filtered SAMs",
    )
    r.add_argument("assembly", help="Assembly to polish (FASTA)")

    b = sub.add_parser(
        "batch",
        help="polish many genomes from a manifest (no reference "
        "counterpart)",
    )
    b.add_argument(
        "manifest",
        help="TSV manifest: assembly<TAB>output<TAB>sam1[,sam2...] per line",
    )
    _add_polish_options(b, debug=False)
    _add_device_option(b)
    b.add_argument(
        "--workers", type=int, default=None,
        help="Genomes polished at once (default: min(8, cores, jobs))",
    )
    b.add_argument(
        "--resume", action="store_true",
        help="Skip jobs whose output already exists and is newer than "
        "its inputs",
    )
    b.add_argument(
        "--shard-across-hosts", action="store_true",
        help="Each process of a process group polishes the "
        "jobs[rank::world] slice of the manifest (the group comes from "
        "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/JAX_PROCESS_ID)",
    )
    return parser


def _add_filter_options(f: argparse.ArgumentParser) -> None:
    f.add_argument(
        "--orientation", default="auto", help="Expected pair orientation (default: auto)"
    )
    f.add_argument(
        "--low", type=float, default=0.1, help="Low percentile threshold (default: 0.1)"
    )
    f.add_argument(
        "--high", type=float, default=99.9,
        help="High percentile threshold (default: 99.9)",
    )


def _add_polish_options(p: argparse.ArgumentParser,
                        debug: bool = True) -> None:
    if debug:
        p.add_argument(
            "--debug", default=None,
            help="Optional file to store per-base information for "
            "debugging purposes",
        )
    p.add_argument(
        "-i", "--fraction_invalid", type=float, default=0.2,
        help="A base must make up less than this fraction of the read depth "
        "to be considered invalid (default: 0.2)",
    )
    p.add_argument(
        "-v", "--fraction_valid", type=float, default=0.5,
        help="A base must make up at least this fraction of the read depth "
        "to be considered valid (default: 0.5)",
    )
    p.add_argument(
        "-m", "--max_errors", type=int, default=10,
        help="Ignore alignments with more than this many mismatches and "
        "indels (default: 10)",
    )
    p.add_argument(
        "-d", "--min_depth", type=int, default=5,
        help="A base must occur at least this many times in the pileup to "
        "be considered valid (default: 5)",
    )
    p.add_argument(
        "--careful", action="store_true",
        help="Ignore any reads with multiple alignments",
    )
    p.add_argument(
        "--threads", type=int, default=None,
        help="Native SAM parser threads (default: all cores, max 16; in "
        "batch 1 per genome when several are in flight; output is "
        "bit-identical for any value)",
    )
    p.add_argument(
        "--backend", default="auto",
        choices=("auto", "device", "host", "xla", "sharded"),
        help="Vote/consensus backend: 'auto' (default: the one the "
        "transport cost model predicts fastest), 'device' (the CUDA "
        "kernels), 'host' (the host fold), 'xla' (a torch scatter-add "
        "on --device) or 'sharded' (a (data, pos) grid over --device's "
        "visible devices)",
    )
    p.add_argument(
        "--kernel-variant", default=None, choices=("lanes", "mxu"),
        help="Vote kernel of --backend device and sharded: 'lanes' (the "
        "lanes vote kernel) or 'mxu' (the chunk vote kernel; a scatter "
        "per grid cell on sharded); default POLYPOLISH_TPU_KERNEL, else "
        "lanes",
    )
    p.add_argument(
        "--pure-python", action="store_true",
        help="Read the SAM files with the pure-Python reader instead of "
        "the native (C++) engine",
    )


def _add_pod_option(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--pod-shards", type=int, default=0,
        help="Shard the SAM ingest over N byte-range shards and fold on "
        "the host (output is bit-identical to unsharded)",
    )


def _add_distributed_options(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--distributed", action="store_true",
        help="Multi-process pod polish: launch one copy of this command "
        "per process, shard the SAM ingest across them and merge over a "
        "gloo process group. The group comes from --coordinator/"
        "--num-processes/--process-id or the JAX_COORDINATOR_ADDRESS/"
        "JAX_NUM_PROCESSES/JAX_PROCESS_ID variables. Process 0 writes "
        "the output; bit-identical to single-process polish",
    )
    p.add_argument(
        "--coordinator", default=None,
        help="Address host:port of process 0 (with --distributed)",
    )
    p.add_argument(
        "--num-processes", type=int, default=None,
        help="Total process count (with --distributed)",
    )
    p.add_argument(
        "--process-id", type=int, default=None,
        help="This process's index (with --distributed)",
    )


def _add_device_option(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="Torch device of the device steps (default: cuda; cpu runs "
        "the kernels' plain PyTorch versions)",
    )


def _resolve_backend(requested: str, sam_paths=None, mean_job_sams=None,
                     device="cuda") -> str:
    """auto = the backend that the cost model of utils/transport.py
    predicts fastest for this workload's SAM bytes on the measured link
    (the JAX package's _resolve_backend; its "pallas" is "device").
    Prints a note when a GPU is in use but the device path is predicted
    slower.

    mean_job_sams: batch mode, a sample of per-job SAM path lists; the
    model runs on the mean job size (the prediction applies per
    genome).  Only a missing GPU or ``device`` cpu resolves to host
    without a prediction; a failing link probe raises."""
    if requested != "auto":
        return requested
    from polypolish_tpu_torch.utils.transport import predict_backend

    def _size(paths):
        total = 0
        for p in paths or []:
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    if mean_job_sams:
        sizes = [_size(job) for job in mean_job_sams]
        sizes = [s for s in sizes if s > 0]
        sam_bytes = int(sum(sizes) / len(sizes)) if sizes else 0
    else:
        sam_bytes = _size(sam_paths)
    if sam_bytes <= 0:
        sam_bytes = 500 << 20  # unknown workload: E. coli scale
    choice, details = predict_backend(sam_bytes, device=device)
    if choice == "host" and "predicted_device_s" in details:
        print(
            "note: GPU attached but the device path is predicted "
            f"slower on this link for this workload "
            f"(device ~{details['predicted_device_s']}s vs host "
            f"~{details['predicted_host_s']}s); using the host "
            "backend (--backend device to force the device path)",
            file=sys.stderr,
        )
    return choice


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    parser = build_parser()
    if not argv:
        parser.print_help(sys.stderr)
        return 2
    args = parser.parse_args(argv)
    from polypolish_tpu_torch.utils.malloc_tuning import tune_malloc

    tune_malloc()
    try:
        if args.command == "filter":
            from polypolish_tpu_torch.pipeline.filtering import filter_pairs

            filter_pairs(
                args.in1, args.in2, args.out1, args.out2,
                args.orientation, args.low, args.high, device=args.device,
            )
        elif args.command == "polish" and args.distributed:
            return _polish_distributed(args)
        elif args.command == "polish" and args.pod_shards > 1:
            from polypolish_tpu_torch.pipeline.pod import (
                polish_pod,
                refuse_or_note,
            )

            refuse_or_note(not args.pure_python, args.backend)
            polish_pod(
                args.debug, args.fraction_invalid, args.fraction_valid,
                args.max_errors, args.min_depth, args.careful,
                args.assembly, args.sam, args.pod_shards,
                n_threads=args.threads,
            )
        elif args.command == "polish":
            from polypolish_tpu_torch.pipeline.polish import polish

            polish(
                args.debug, args.fraction_invalid, args.fraction_valid,
                args.max_errors, args.min_depth, args.careful,
                args.assembly, args.sam,
                backend=_resolve_backend(args.backend, args.sam,
                                         device=args.device),
                n_threads=args.threads, device=args.device,
                kernel_variant=args.kernel_variant,
                use_native=not args.pure_python,
            )
        elif args.command == "batch":
            from polypolish_tpu_torch.pipeline.batch import (
                parse_manifest,
                polish_batch,
            )

            jobs = parse_manifest(args.manifest)
            if args.shard_across_hosts:
                from polypolish_tpu_torch.parallel.multihost import (
                    initialize_distributed,
                )

                initialize_distributed()
            results = polish_batch(
                jobs,
                fraction_invalid=args.fraction_invalid,
                fraction_valid=args.fraction_valid,
                max_errors=args.max_errors, min_depth=args.min_depth,
                careful=args.careful,
                # the prediction applies per genome: model the mean job
                # over up to 20 manifest entries
                backend=_resolve_backend(
                    args.backend, mean_job_sams=[j[2] for j in jobs[:20]],
                    device=args.device),
                use_native=not args.pure_python, workers=args.workers,
                resume=args.resume, n_threads=args.threads,
                device=args.device, kernel_variant=args.kernel_variant,
                shard_across_hosts=args.shard_across_hosts,
            )
            if any("error" in r for r in results):
                return 1
        else:
            from polypolish_tpu_torch.pipeline.full import polish_paired

            polish_paired(
                args.assembly, args.in1, args.in2,
                orientation=args.orientation, low=args.low, high=args.high,
                debug=args.debug, fraction_invalid=args.fraction_invalid,
                fraction_valid=args.fraction_valid,
                max_errors=args.max_errors, min_depth=args.min_depth,
                careful=args.careful,
                backend=_resolve_backend(args.backend, [args.in1, args.in2],
                                         device=args.device),
                use_native=not args.pure_python,
                n_threads=args.threads, pod_shards=args.pod_shards,
                keep_filtered=args.keep_filtered,
                kernel_variant=args.kernel_variant, device=args.device,
            )
    except PolypolishError as e:
        render_error_and_exit(e)
    finally:
        from polypolish_tpu_torch.parallel.multihost import (
            shutdown_distributed,
        )

        shutdown_distributed()
    return 0


def _polish_distributed(args) -> int:
    """polish --distributed: join the process group, then the pod polish
    of pipeline/pod_distributed.py; rank 0 writes the FASTA.  gloo's
    native layers write to fd 1, so the FASTA goes to a duplicate of the
    real stdout and fd 1 points at stderr before the group starts.  The
    refusal without a coordinator is the JAX CLI's, word for word."""
    from polypolish_tpu_torch.errors import quit_with_error
    from polypolish_tpu_torch.parallel.multihost import initialize_distributed
    from polypolish_tpu_torch.pipeline.pod_distributed import (
        polish_pod_distributed,
    )

    sys.stdout.flush()
    fasta_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    try:
        if not initialize_distributed(args.coordinator, args.num_processes,
                                      args.process_id):
            quit_with_error(
                "--distributed requires a coordinator: pass "
                "--coordinator/--num-processes/--process-id, set "
                "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                "JAX_PROCESS_ID, or run under a TPU pod runtime"
            )
        polish_pod_distributed(
            args.debug, args.fraction_invalid, args.fraction_valid,
            args.max_errors, args.min_depth, args.careful,
            args.assembly, args.sam, out=fasta_out,
            n_threads=args.threads, device=args.device,
        )
    finally:
        fasta_out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
