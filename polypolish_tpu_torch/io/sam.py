"""SAM line parsing into alignment records (counterpart of
polypolish_tpu/io/sam.py; reference: alignment.rs:32-128), the
pure-Python reader of ``--pure-python``.  Two parse levels, as in the
reference:

- ``parse_alignment_full`` (polish, alignment.rs:49-98): keeps the
  uppercased read sequence and the expanded CIGAR; requires an ``NM:i:``
  tag on aligned reads; a ``ZP:Z:fail`` tag (any case) clears pass_qc.
- ``parse_alignment_quick`` (filter, alignment.rs:102-128): only
  name/flags/ref/start/cigar.

ref_start: SAM is 1-based; stored 0-based by subtracting 1 when > 0.
"""

from __future__ import annotations

from typing import Optional

from polypolish_tpu_torch.errors import quit_with_error
from polypolish_tpu_torch.ops.cigar import (
    InvalidCigar,
    expand_cigar,
    ref_end_from_cigar,
)

U32_MAX = 0xFFFFFFFF


class TooFewColumns(ValueError):
    pass


class MissingNmTag(ValueError):
    pass


class Alignment:
    """One SAM alignment record (the polish path's fields)."""

    __slots__ = (
        "read_name",
        "ref_name",
        "sam_flags",
        "ref_start",
        "cigar",
        "expanded_cigar",
        "read_seq",
        "mismatches",
        "pass_qc",
    )

    def __init__(
        self,
        read_name: str,
        ref_name: str,
        sam_flags: int,
        ref_start: int,
        cigar: str,
        expanded_cigar: str,
        read_seq: str,
        mismatches: int,
        pass_qc: bool,
    ) -> None:
        self.read_name = read_name
        self.ref_name = ref_name
        self.sam_flags = sam_flags
        self.ref_start = ref_start
        self.cigar = cigar
        self.expanded_cigar = expanded_cigar
        self.read_seq = read_seq
        self.mismatches = mismatches
        self.pass_qc = pass_qc

    # --- flag helpers (alignment.rs:130-153) ---
    def is_aligned(self) -> bool:
        return (self.sam_flags & 4) == 0

    def is_on_forward_strand(self) -> bool:
        return (self.sam_flags & 16) == 0

    def get_strand(self) -> int:
        return 1 if self.is_on_forward_strand() else -1

    def get_ref_end(self) -> int:
        return ref_end_from_cigar(self.cigar, self.ref_start)

    def starts_and_ends_with_match(self) -> bool:
        """End-to-end check: the expanded CIGAR starts and ends with M or
        = (alignment.rs:155-159)."""
        if not self.expanded_cigar:
            return False
        first = self.expanded_cigar[0]
        last = self.expanded_cigar[-1]
        return (first == "M" or first == "=") and (last == "M" or last == "=")

    def __repr__(self) -> str:  # alignment.rs:205-211
        strand = "+" if self.is_on_forward_strand() else "-"
        return (
            f"{self.read_name}:{self.ref_name}{strand}:"
            f"{self.ref_start}-{self.get_ref_end()}"
        )


def parse_alignment_full(sam_line: str) -> Alignment:
    """Full parse for the polish path (alignment.rs:49-98).

    Raises TooFewColumns / MissingNmTag for per-line errors the caller
    wraps with file and line; an invalid CIGAR is fatal at once with the
    reference's message.
    """
    parts = sam_line.split("\t")
    if len(parts) < 11:
        raise TooFewColumns()

    read_name = parts[0]
    sam_flags = int(parts[1])
    ref_name = parts[2]
    ref_start = int(parts[3])
    if ref_start > 0:
        ref_start -= 1
    cigar = parts[5]
    read_seq = parts[9]

    mismatches = U32_MAX
    pass_qc = True
    for p in parts[11:]:
        if p.startswith("NM:i:"):
            mismatches = int(p[5:])
        if p.lower() == "zp:z:fail":
            pass_qc = False
    if mismatches == U32_MAX and (sam_flags & 4) == 0:
        raise MissingNmTag()

    try:
        expanded_cigar = expand_cigar(cigar)
    except InvalidCigar:
        quit_with_error(
            f'encountered an invalid CIGAR string for read {read_name}: "{cigar}"'
        )

    return Alignment(
        read_name=read_name,
        ref_name=ref_name,
        sam_flags=sam_flags,
        ref_start=ref_start,
        cigar=cigar,
        expanded_cigar=expanded_cigar,
        read_seq=read_seq.upper(),
        mismatches=mismatches,
        pass_qc=pass_qc,
    )


def parse_alignment_quick(sam_line: str) -> Alignment:
    """Quick parse for the filter path (alignment.rs:102-128)."""
    parts = sam_line.split("\t")
    if len(parts) < 11:
        raise TooFewColumns()
    ref_start = int(parts[3])
    if ref_start > 0:
        ref_start -= 1
    return Alignment(
        read_name=parts[0],
        ref_name=parts[2],
        sam_flags=int(parts[1]),
        ref_start=ref_start,
        cigar=parts[5],
        expanded_cigar="",
        read_seq="",
        mismatches=0,
        pass_qc=True,
    )


def error_label(err: ValueError) -> Optional[str]:
    """The reference's per-line error strings (alignment.rs:51,76-78)."""
    if isinstance(err, TooFewColumns):
        return "too few columns"
    if isinstance(err, MissingNmTag):
        return "missing NM tag"
    return None
