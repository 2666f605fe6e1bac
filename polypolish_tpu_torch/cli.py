"""Command-line interface (counterpart of polypolish_tpu/cli.py;
reference: main.rs:23-126).

The port carries the ``polish``, ``filter`` and ``full`` subcommands:

  python -m polypolish_tpu_torch polish [--debug FILE] [-i 0.2] [-v 0.5]
      [-m 10] [-d 5] [--careful] [--threads N]
      [--backend device|host|xla] [--kernel-variant lanes|mxu]
      [--device cuda|cpu] assembly sam [sam ...]
  python -m polypolish_tpu_torch filter --in1 .. --in2 .. --out1 ..
      --out2 .. [--orientation auto] [--low 0.1] [--high 99.9]
      [--device cuda|cpu]
  python -m polypolish_tpu_torch full --in1 .. --in2 .. [filter and
      polish options] [--keep-filtered DIR] assembly

``--backend device`` (default) counts votes with the port's CUDA kernels
on ``--device`` (default cuda; cpu runs their plain PyTorch versions):
the lanes vote kernel (``--kernel-variant lanes``, default) or the chunk
vote kernel (``mxu``); ``--backend xla`` counts the chunk layout with a
torch scatter-add on ``--device``; ``--backend host`` runs the C++ fold
and consensus.  ``filter`` runs its pair grids of 1 M entries or more as
torch ops on ``--device``; ``full`` runs ``filter`` and then ``polish``.
"""

from __future__ import annotations

import argparse
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
    _add_device_option(p)
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
    r.add_argument(
        "--keep-filtered", default=None,
        help="Directory to keep the intermediate filtered SAMs",
    )
    r.add_argument("assembly", help="Assembly to polish (FASTA)")
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


def _add_polish_options(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--debug", default=None,
        help="Optional file to store per-base information for debugging purposes",
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
        help="Native SAM parser threads (default: all cores, max 16; "
        "output is bit-identical for any value)",
    )
    p.add_argument(
        "--backend", default="device", choices=("device", "host", "xla"),
        help="Vote/consensus backend: 'device' (the CUDA kernels, "
        "default), 'host' (the C++ fold) or 'xla' (a torch scatter-add "
        "on --device)",
    )
    p.add_argument(
        "--kernel-variant", default="lanes", choices=("lanes", "mxu"),
        help="Vote kernel of --backend device: 'lanes' (the lanes vote "
        "kernel, default) or 'mxu' (the chunk vote kernel)",
    )


def _add_device_option(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="Torch device of the device steps (default: cuda; cpu runs "
        "the kernels' plain PyTorch versions)",
    )


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    parser = build_parser()
    if not argv:
        parser.print_help(sys.stderr)
        return 2
    args = parser.parse_args(argv)
    try:
        if args.command == "filter":
            from polypolish_tpu_torch.pipeline.filtering import filter_pairs

            filter_pairs(
                args.in1, args.in2, args.out1, args.out2,
                args.orientation, args.low, args.high, device=args.device,
            )
        elif args.command == "polish":
            from polypolish_tpu_torch.pipeline.polish import polish

            polish(
                args.debug, args.fraction_invalid, args.fraction_valid,
                args.max_errors, args.min_depth, args.careful,
                args.assembly, args.sam,
                backend=args.backend, n_threads=args.threads,
                device=args.device, kernel_variant=args.kernel_variant,
            )
        else:
            from polypolish_tpu_torch.pipeline.full import polish_paired

            polish_paired(
                args.assembly, args.in1, args.in2,
                orientation=args.orientation, low=args.low, high=args.high,
                debug=args.debug, fraction_invalid=args.fraction_invalid,
                fraction_valid=args.fraction_valid,
                max_errors=args.max_errors, min_depth=args.min_depth,
                careful=args.careful, backend=args.backend,
                n_threads=args.threads, keep_filtered=args.keep_filtered,
                kernel_variant=args.kernel_variant, device=args.device,
            )
    except PolypolishError as e:
        render_error_and_exit(e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
