"""Per-contig records of the assembly (counterpart of
polypolish_tpu/ops/pack.py).

Only what ``load_assembly`` needs is here: the port parses SAM files
with the native run engine alone, so the pure-Python event packer of
the JAX package (read grouping, QC, CIGAR walking) has no counterpart
yet.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class ContigVotes:
    """One assembly contig (the reference's ``Pileup`` owner): name,
    FASTA description and sequence.  Its votes live in the native run
    engine (native/runs.py), not in this object."""

    __slots__ = ("name", "description", "seq", "length")

    def __init__(self, name: str, description: str, seq: str) -> None:
        self.name = name
        self.description = description
        self.seq = seq
        self.length = len(seq)


def new_votes_from_fasta(
    fasta: List[Tuple[str, str, str]]
) -> Dict[str, ContigVotes]:
    return {name: ContigVotes(name, desc, seq) for name, desc, seq in fasta}
